#!/usr/bin/env python
"""Public entry point on the PyTorch port: train the BRIDGeR controller, on
the GPU unless ``--device cpu``.  Thin wrapper over
vla_touch_tpu_torch.train.bridge_train: the flags of bridge_train.py, plus
``--device``."""
from vla_touch_tpu_torch.train.bridge_train import main

if __name__ == "__main__":
    main()
