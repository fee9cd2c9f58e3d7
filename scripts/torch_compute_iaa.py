#!/usr/bin/env python
"""Reference-invocation shim of the PyTorch port: `python
scripts/torch_compute_iaa.py ...` takes the arguments of scripts/compute_iaa.py; the
implementation lives in whisper_ipa_torch.cli.compute_iaa."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from whisper_ipa_torch.cli.compute_iaa import main

if __name__ == "__main__":
    main()
