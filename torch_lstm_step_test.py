#!/usr/bin/env python
"""Public entry point on the PyTorch port: evaluate an LSTM controller
checkpoint, on the GPU unless ``--device cpu``.  Thin wrapper over
vla_touch_tpu_torch.eval.lstm_step_test: the flags of lstm_step_test.py,
plus ``--device``."""
from vla_touch_tpu_torch.eval.lstm_step_test import main

if __name__ == "__main__":
    main()
