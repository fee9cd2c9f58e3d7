#!/usr/bin/env python
"""Reference-invocation shim of the PyTorch port for the out-of-process
speed monitor (`python scripts/torch_calculate_real_speed.py [PID]
[CKPT_DIR] [STEPS] [BATCH]`, the arguments of calculate_real_speed.py);
the implementation lives in whisper_ipa_torch.cli.calculate_real_speed."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from whisper_ipa_torch.cli.calculate_real_speed import main

if __name__ == "__main__":
    main()
