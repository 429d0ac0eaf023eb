#!/usr/bin/env python
"""Public entry point on the PyTorch port: evaluate a BRIDGeR checkpoint, on
the GPU unless ``--device cpu``.  Thin wrapper over
vla_touch_tpu_torch.eval.bridge_test: the flags of bridger_test.py, plus
``--device``."""
from vla_touch_tpu_torch.eval.bridge_test import main

if __name__ == "__main__":
    main()
