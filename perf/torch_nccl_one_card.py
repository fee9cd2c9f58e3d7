#!/usr/bin/env python3
"""What NCCL answers when two ranks share one card.

    python3 perf/torch_nccl_one_card.py [--timeout SECONDS]

Starts two processes with torchrun's environment; each joins an NCCL
process group on cuda:0 (``whisper_ipa_torch.parallel.initialize`` with a
60 s collective timeout through ``TORCH_NCCL_BLOCKING_WAIT``) and
all-reduces one tensor. Prints the card, the torch and NCCL versions and
each rank's outcome: the sum, or the last lines of its error (NCCL
refuses two ranks on one device as a duplicate GPU). The processes are
killed at the time limit. Exits 0 whatever NCCL answers; it records.
"""

import argparse
import os
import socket
import subprocess
import sys

RANK = r"""
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, os.getcwd())
from whisper_ipa_torch.parallel import distributed as D, initialize
initialize(device="cuda:0")
x = torch.ones(4, device="cuda:0") * (int(os.environ["RANK"]) + 1)
D.all_reduce(x)
torch.cuda.synchronize()
print("sum", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    import torch

    print(f"card {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   TORCH_NCCL_BLOCKING_WAIT="1", NCCL_DEBUG="WARN")
        procs.append(subprocess.Popen([sys.executable, "-c", RANK], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=args.timeout)
            status = f"exit {p.returncode}"
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            status = f"killed after {args.timeout:g} s"
        lines = [ln for ln in out.splitlines() if ln.strip()]
        print(f"--- rank {r}: {status}")
        print("\n".join(lines[-12:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
