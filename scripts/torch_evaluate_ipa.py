#!/usr/bin/env python
"""Reference-invocation shim of the PyTorch port: `python
scripts/torch_evaluate_ipa.py ...` takes the arguments of scripts/evaluate_ipa.py; the
implementation lives in whisper_ipa_torch.cli.evaluate_ipa."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from whisper_ipa_torch.cli.evaluate_ipa import main

if __name__ == "__main__":
    main()
