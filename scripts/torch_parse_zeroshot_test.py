#!/usr/bin/env python
"""Reference-invocation shim of the PyTorch port: `python
scripts/torch_parse_zeroshot_test.py ...` takes the arguments of scripts/parse_zeroshot_test.py; the
implementation lives in whisper_ipa_torch.cli.parse_zeroshot_test."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from whisper_ipa_torch.cli.parse_zeroshot_test import main

if __name__ == "__main__":
    main()
