"""The benchmark of the PyTorch and CUDA port (``whisper_ipa_torch``) on an
NVIDIA card: offline transcription and decoder-only fine-tuning of Whisper
at published sizes. ``run.py`` runs one cell once; ``BENCHMARK.json`` at
the repository's root lists the cells and metrics."""
