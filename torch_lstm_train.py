#!/usr/bin/env python
"""Public entry point on the PyTorch port: train the LSTM residual
controller, on the GPU unless ``--device cpu``.  Thin wrapper over
vla_touch_tpu_torch.train.lstm_train: the flags of lstm_train.py, plus
``--device``."""
from vla_touch_tpu_torch.train.lstm_train import main

if __name__ == "__main__":
    main()
