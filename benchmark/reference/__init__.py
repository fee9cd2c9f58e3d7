"""The plain reference that decides ``correct``: Whisper's log-mel frontend,
forward pass, loss and AdamW in plain PyTorch and float32 (TF32 off).

It follows the published model (Radford et al. 2022, "Robust Speech
Recognition via Large-Scale Weak Supervision", and openai/whisper's
``model.py`` / ``audio.py``) and optax's AdamW numerics. It imports
nothing of the system under test: it reads the harness's weights and
inputs, and recomputes everything the program derives from them.
"""
