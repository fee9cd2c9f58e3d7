#!/usr/bin/env python3
"""The in-flight engine over NCCL, one process a card of one host.

    python3 perf/torch_engine_nccl.py [--meshes 2x2,1x4,4x1] [--dry-run]

Builds the kernels once in this process (``ops._build.build_all``), then
spawns one process a card (``data x model`` of the largest mesh; 4 for
the default), each joining an NCCL group through
``parallel.initialize``. Every mesh of ``--meshes`` (data x model) runs
``serve_continuous.ContinuousBatcher`` at whisper-small, random weights
from seed 0, bf16, the int8 cross cache, 8 slots, 24 tokens a window, on
``chip_smoke.py``'s seeded stream of 6 requests (5-40 s, 20-60 ms apart),
rank 0 submitting while the others follow
(``chip_smoke.engine_mesh_cases``, as its phase_parallel runs the engine
over two ranks). Then rank 0 runs
the engine alone on its card on the same stream, and decode() on every
window: each run's tokens are held to decode() under chip_smoke's
near-tie rule (``chip_smoke.engine_mesh_agree``). Prints a line a mesh: the wall, tokens a
second against one rank, each rank's K1/K2/K4 launches against the
prediction from its installs and steps (a failed gate exits 1), the
windows equal to decode()'s; and every card's name and power limit.

``--dry-run`` runs the same program on the CPU over gloo at a narrow
test-tiny (no card, no kernel: the plain versions), to check the script.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _no_card(torch) -> None:
    """--dry-run: the CUDA calls chip_smoke's helpers make, as no-ops."""
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0


def rank_main(rank: int, world: int, port: int, meshes, dry: bool,
              out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1 if dry else 4)
    if dry:
        _no_card(torch)
    import chip_smoke as cs
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.models.convert import flatten_params, unflatten_params
    from whisper_ipa_torch.parallel import initialize
    from whisper_ipa_torch.tokenizer import get_tokenizer

    dev = torch.device("cpu") if dry else torch.device("cuda", rank)
    initialize(f"localhost:{port}", world, rank, device=dev)
    cfg = CONFIGS["small"]
    if dry:
        cfg = replace(CONFIGS["test-tiny"], n_audio_state=64, n_audio_head=4,
                      n_audio_layer=2, n_text_state=64, n_text_head=4,
                      n_text_layer=2)
    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    host = init_params(cfg, seed=0)

    def fresh():
        return unflatten_params({n: t.to(dev, copy=True)
                                 for n, t in flatten_params(host).items()})

    clips, gaps = cs.engine_stream(cs.PARALLEL_REQUESTS, seed=70)
    out = dict(rank=rank, backend=dist.get_backend())
    runs = cs.engine_mesh_cases(
        torch, cfg, tok, fresh,
        [(f"{d}x{m}", d, m, {}) for d, m in meshes], clips, gaps, out)
    if rank == 0:
        out["agree"], out["eps"], *_ = cs.engine_mesh_agree(
            torch, dev, cfg, tok, fresh, clips, gaps, runs)
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="2x2,1x4,4x1",
                    help="data x model meshes, comma-separated")
    ap.add_argument("--dry-run", action="store_true",
                    help="the CPU over gloo at a narrow test-tiny")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    meshes = [tuple(int(x) for x in m.split("x"))
              for m in args.meshes.split(",")]
    world = max(d * m for d, m in meshes)
    if any(d * m != world for d, m in meshes):
        raise SystemExit("every mesh must span the same world")
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs

    if not args.dry_run:
        if torch.cuda.device_count() < world:
            print(f"needs {world} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print("cards:", "; ".join(smi.stdout.strip().splitlines()), flush=True)
        print(f"torch {torch.__version__}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
        from whisper_ipa_torch.ops import _build

        t0 = time.time()
        _build.build_all()
        print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="engine_nccl_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, port, meshes,
                                                 args.dry_run, out_dir))
             for r in range(world)]
    t0 = time.time()
    for p in procs:
        p.start()
    failed = False
    while any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs) or (
                time.time() - t0 > args.timeout):
            failed = True
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(timeout=30)
    if failed or any(p.exitcode != 0 for p in procs):
        print(f"ranks' exit codes {[p.exitcode for p in procs]}",
              file=sys.stderr)
        return 1
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    agree = ranks[0]["agree"]
    one = agree["engine one rank"]
    ok = True
    for name in [f"{d}x{m}" for d, m in meshes] + ["engine one rank"]:
        a = agree[name]
        rate = a["tokens"] / a["wall"]
        line = (f"[{ranks[0]['backend']} {name}] {a['tokens']} tokens in "
                f"{a['wall']:.4f} s, {rate:.1f} tokens/s "
                f"({rate / (one['tokens'] / one['wall']):.3f}x one rank); "
                f"{a['equal']} of {a['windows']} windows equal decode()'s, "
                f"{a['near_ties']} at a near-tie (gaps {a['gaps']}, eps "
                f"{ranks[0]['eps']:.3e})")
        if name != "engine one rank":
            for r in ranks:
                got, want = (cs.nonzero(r[k][name]) for k in ("paths", "want"))
                good = args.dry_run or got == want
                ok = ok and good
                line += (f"\n    rank {r['rank']}: launches {got} (predicted "
                         f"{want}{'' if good else ': NOT MET'}), stats "
                         f"{r['stats'][name]}, self_k "
                         f"{r['shapes'][name]['self_k']}, wall "
                         f"{r['walls'][name]:.4f} s")
        print(line, flush=True)
    print(f"total {time.time() - t0:.1f} s of ranks", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
