"""Rank worker of the port's multi-rank CPU tests (no jax imported here).

``launch(world, plan, out_dir)`` starts ``world`` processes of this file
with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), so each joins a gloo group through
``whisper_ipa_torch.parallel.initialize`` as a torchrun launch would. Each
rank runs the plan's scenarios in order (every one a collective program)
and writes {scenario: result} to ``out_dir/rank{r}.pkl``; ``launch``
returns the ranks' dicts and raises if any rank failed.

A plan is a pickled dict: {"scenarios": [(name, kwargs), ...], ...shared
inputs}. The test files build the plans and hold the results against the
JAX package.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from dataclasses import replace

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world: int, plan: dict, out_dir: str, timeout: float = 600):
    return collect(start(world, plan, out_dir), timeout)


def start(world: int, plan: dict, out_dir: str):
    """Start the ranks; ``collect`` waits for them."""
    os.makedirs(out_dir, exist_ok=True)
    plan_path = os.path.join(out_dir, "plan.pkl")
    with open(plan_path, "wb") as f:
        pickle.dump(plan, f)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), plan_path, out_dir],
            env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    return procs, out_dir


def collect(handle, timeout: float = 600):
    procs, out_dir = handle
    world = len(procs)
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{logs[r][-4000:]}" for r in bad))
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results, logs


# -- shared helpers inside a rank ------------------------------------------


def _cfg(fields: dict):
    from whisper_ipa_torch.config import CONFIGS

    return replace(CONFIGS["test-tiny"], **fields)


def _params(plan):
    from whisper_ipa_torch.models import params_from_numpy

    with np.load(plan["params_npz"]) as npz:
        return params_from_numpy(dict(npz))


def _full(state):
    """The whole parameter tree of a sharded state, as numpy."""
    from whisper_ipa_torch.models.convert import flatten_params

    return {n: state.layout.params[n].gather(t).numpy().copy()
            for n, t in flatten_params(state.params).items()}


def _sharded_state(plan, kind, data, model, mesh, *, train_kw):
    """The state and step of one regime: "dp" (replicated moments),
    "zero1" or "fsdp", each over the mesh, TP when model > 1."""
    from whisper_ipa_torch.parallel import (
        fsdp_param_shardings,
        opt_state_shardings,
        param_shardings,
        shard_params,
    )
    from whisper_ipa_torch.parallel.mesh import place_params, replicate
    from whisper_ipa_torch.train import create_train_state
    from whisper_ipa_torch.train.step import create_train_state_zero1

    tp = model > 1
    params = _params(plan)
    if kind == "fsdp":
        sh = fsdp_param_shardings(mesh, params, tensor_parallel=tp)
        params = place_params(replicate(mesh, params), sh)
        state, tx, osh = create_train_state_zero1(mesh, params, tensor_parallel=tp,
                                                  **train_kw)
        return state, tx, osh, sh
    params = shard_params(mesh, params, tensor_parallel=tp)
    sh = param_shardings(mesh, params) if tp else None
    if kind == "zero1":
        state, tx, osh = create_train_state_zero1(mesh, params, tensor_parallel=tp,
                                                  **train_kw)
    else:
        state, tx = create_train_state(params, **train_kw)
        osh = opt_state_shardings(mesh, tx, params, tensor_parallel=tp, zero1=False)
    return state, tx, osh, sh


# -- scenarios ---------------------------------------------------------------


def sc_collectives(plan):
    """The helpers' identities on the world group."""
    import torch
    import torch.distributed as dist

    from whisper_ipa_torch.parallel import distributed as D
    from whisper_ipa_torch.parallel import process_info, local_shard_indices

    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.arange(6, dtype=torch.float32) + r
    s = D.all_reduce(x.clone())
    g = D.all_gather(x[None].clone(), dim=0)
    rs = D.reduce_scatter(torch.ones(2 * n, 3) * (r + 1), dim=0)
    b = D.broadcast(torch.full((2,), float(r)), src=n - 1)
    return dict(sum=s.numpy(), gather=g.numpy(), scatter=rs.numpy(),
                bcast=b.numpy(), info=process_info(),
                shard=local_shard_indices(10))


def sc_train(plan, kind, data, model, steps, train_kw, batch):
    """``steps`` steps of one regime on the rank's rows of the batch."""
    import torch

    from whisper_ipa_torch.models.convert import flatten_params
    from whisper_ipa_torch.parallel import make_mesh, shard_batch
    from whisper_ipa_torch.train.step import make_zero1_step

    cfg = _cfg(plan["cfg"])
    mesh = make_mesh(data=data, model=model)
    state, tx, osh, sh = _sharded_state(plan, kind, data, model, mesh,
                                        train_kw=train_kw)
    step = make_zero1_step(mesh, cfg, tx, plan["eot"], osh, param_shardings=sh,
                           freeze_encoder=train_kw["freeze_encoder"])
    mel, tokens = shard_batch(mesh, plan[batch]["mel"],
                              plan[batch]["tokens"].astype(np.int64))
    losses = []
    for _ in range(steps):
        state, loss = step(state, mel, tokens)
        losses.append(float(loss))
    local = {n: tuple(t.shape) for n, t in state.opt_state.mu.items()}
    local_p = {n: tuple(t.shape) for n, t in flatten_params(state.params).items()}
    torch.distributed.barrier()
    return dict(losses=losses, params=_full(state), mu_shapes=local,
                param_shapes=local_p)


def sc_decode(plan, model, options):
    """Greedy / beam / int8-cache tokens with TP-sharded parameters."""
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.parallel import make_mesh, shard_params
    from whisper_ipa_torch.tokenizer import get_tokenizer

    cfg = _cfg(plan["cfg"])
    mesh = make_mesh(model=model)
    params = shard_params(mesh, _params(plan), tensor_parallel=True)
    tok = get_tokenizer(multilingual=True, language="en")
    out = {}
    for name, kw in options.items():
        res = decode(params, cfg, plan["decode_mel"], DecodingOptions(**kw),
                     tokenizer=tok, tp=mesh.tp)
        out[name] = [r.tokens for r in res]
    out["q_shape"] = tuple(params["decoder"]["blocks"][0]["attn"]["query"]["w"].shape)
    return out


def sc_validate(plan, data):
    """validate(mesh=) and evaluate_model(data_parallel=True)."""
    from whisper_ipa_torch.cli.evaluate_model import evaluate_model
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.parallel import make_mesh, replicate
    from whisper_ipa_torch.train.loop import validate

    cfg = _cfg(plan["val_cfg"])
    params = _params(dict(params_npz=plan["val_params_npz"]))
    mesh = make_mesh(data=data)
    dataset = create_data_loader(plan["dataset"], n_mels=cfg.n_mels)
    v = validate(replicate(mesh, params), cfg, dataset, dataset.tokenizer,
                 num_samples=6, val_batch_size=4, mesh=mesh)
    e = evaluate_model(params, cfg, plan["dataset"], 5, "Model", 2, "en", True)
    return dict(validate=v, hypotheses=e["hypotheses"], per=e["per"])


def sc_checkpoints(plan, out_dir):
    """A ZeRO-1 and an FSDP world save the one-rank file: a one-rank state
    after 2 steps (rank 0), restored into each sharded layout, saved; then
    the JAX package's checkpoint restored into the FSDP layout."""
    import torch
    import torch.distributed as dist

    from whisper_ipa_torch.models.convert import flatten_params
    from whisper_ipa_torch.parallel import make_mesh
    from whisper_ipa_torch.train import create_train_state, train_step
    from whisper_ipa_torch.train.checkpoints import (
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = _cfg(plan["cfg"])
    kw = dict(learning_rate=1e-3, freeze_encoder=False, accum_steps=1)
    one = os.path.join(out_dir, "one")
    if dist.get_rank() == 0:
        state, tx = create_train_state(_params(plan), **kw)
        b = plan["batch4"]
        for _ in range(2):
            state, _ = train_step(state, torch.tensor(b["mel"]),
                                  torch.tensor(b["tokens"].astype(np.int64)),
                                  cfg, tx, plan["eot"], freeze_encoder=False)
        save_checkpoint(state, 2, 1.0, one)
    dist.barrier()
    out = {}
    mesh = make_mesh()
    for kind in ("zero1", "fsdp"):
        tmpl, _, _, _ = _sharded_state(plan, kind, mesh.shape["data"], 1, mesh,
                                       train_kw=kw)
        state, _ = restore_checkpoint(os.path.join(one, "checkpoint-2"), tmpl)
        save_checkpoint(state, 2, 1.0, os.path.join(out_dir, kind))
        out[kind] = dict(
            mu=tuple(state.opt_state.mu["decoder.blocks.0.mlp1.w"].shape),
            w=tuple(state.params["decoder"]["blocks"][0]["mlp1"]["w"].shape),
        )
    # a JAX-written checkpoint restored into the FSDP layout: the gathered
    # state is the file's
    state, _ = restore_checkpoint(plan["jax_ckpt"], tmpl)
    lay = state.layout
    out["from_jax"] = dict(
        step=state.step, count=state.opt_state.count,
        params={n: lay.params[n].gather(t).numpy().copy()
                for n, t in flatten_params(state.params).items()},
        mu={n: lay.opt.mu[n].gather(t).numpy().copy()
            for n, t in state.opt_state.mu.items()},
        nu={n: lay.opt.nu[n].gather(t).numpy().copy()
            for n, t in state.opt_state.nu.items()},
    )
    return out


def sc_service(plan, dp, tp):
    """cli.serve --dp/--tp: rank 0 serves HTTP, the others follow."""
    import functools
    import json
    import threading
    import urllib.request

    from whisper_ipa_torch.cli import serve as serve_cli
    from whisper_ipa_torch.serve import TranscriptionService

    serve_cli.TranscriptionService = functools.partial(TranscriptionService,
                                                       bf16=False)
    argv = ["--model", "test-tiny", "--weights", plan["weights"], "--port", "0",
            "--device", "cpu", "--batch-size", "4", "--dp", str(dp), "--tp",
            str(tp)]
    server, service = serve_cli.build_server(argv)
    if server is None:
        service.follow()
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    texts = []
    for path in plan["wavs"]:
        req = urllib.request.Request(
            f"http://{host}:{port}/transcribe",
            data=json.dumps({"path": path}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            texts.append(json.loads(r.read())["text"])
    server.shutdown()
    server.server_close()
    service.close()
    return dict(texts=texts, stats=service.stats())


def sc_train_cli(plan, flags, out_dir):
    """cli.train_whisper_ipa under the world (torchrun's environment)."""
    from whisper_ipa_torch.cli import train_whisper_ipa as cli

    out = os.path.join(out_dir, "run_" + "_".join(f.strip("-") for f in flags))
    cli.main(["--model", "test-tiny", "--train-data", plan["dataset"],
              "--test-data", plan["dataset"], "--output-dir", out,
              "--batch-size", "2", "--lr", "1e-4", "--steps", "2",
              "--validate-every", "2", "--save-every", "2",
              "--weights", plan["weights"], "--device", "cpu", "--seed", "3"]
             + list(flags))
    import json

    import torch.distributed as dist

    dist.barrier()  # rank 0 writes the summary
    with open(os.path.join(out, "training_summary.json")) as f:
        return json.load(f) | {"dir": out}


SCENARIOS = {
    "collectives": sc_collectives,
    "train": sc_train,
    "decode": sc_decode,
    "validate": sc_validate,
    "checkpoints": sc_checkpoints,
    "service": sc_service,
    "train_cli": sc_train_cli,
}


def main(plan_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO_ROOT)
    from whisper_ipa_torch.parallel import initialize

    initialize(device="cpu")  # torchrun's environment: gloo on the CPU
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    results = {}
    for key, name, kwargs in plan["scenarios"]:
        if name in ("checkpoints", "train_cli"):
            kwargs = dict(kwargs, out_dir=os.path.join(out_dir, key))
        results[key] = SCENARIOS[name](plan, **kwargs)
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
