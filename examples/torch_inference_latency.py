"""Transcription latency probe on synthesized audio, through the PyTorch
port.

The port's counterpart of examples/inference_latency.py: synthesize a
dummy waveform, transcribe it twice with random weights, report latency.
On a CUDA card the first call includes building each hand-written kernel
at its first use (nvcc, unless a build of the same sources is cached) and
the allocator's warm-up; the second is steady state.

  python examples/torch_inference_latency.py [model] [--device cpu | --cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", nargs="?", default="test-tiny")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without a card) or "cpu"')
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = p.parse_args(argv)

    from whisper_ipa_torch.config import CONFIGS, get_config
    from whisper_ipa_torch.data.synth import synthesize_ipa
    from whisper_ipa_torch.decode import transcribe
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.train.loop import resolve_device

    dev = resolve_device("cpu" if args.cpu else args.device)
    cfg = CONFIGS.get(args.model) or get_config(args.model)
    params = init_params(cfg, seed=0, device=dev)

    audio = synthesize_ipa("kæt siː ʃuː aːm")
    print(f"model={cfg.name}, audio {len(audio) / 16000:.2f}s, "
          f"device {dev}")

    t0 = time.time()
    result = transcribe(params, cfg, audio, language="en", temperature=0.0)
    first = time.time() - t0
    label = ("incl. kernel builds at first use" if dev.type == "cuda"
             else "incl. first-call warm-up")
    print(f"first call ({label}): {first:.1f}s")

    t0 = time.time()
    result = transcribe(params, cfg, audio, language="en", temperature=0.0)
    dt = time.time() - t0
    print(f"steady state: {dt * 1e3:.0f} ms "
          f"({len(audio) / 16000 / dt:.1f}x realtime)")
    print(f"text (random weights => gibberish): {result['text'][:60]!r}")
    return {"model": cfg.name, "audio_s": len(audio) / 16000,
            "first_s": first, "steady_s": dt, "text": result["text"]}


if __name__ == "__main__":
    main()
