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
import time
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
    """Start the ranks (each one's output to ``out_dir/rank{r}.log``);
    ``collect`` waits for them."""
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
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), plan_path,
                 out_dir],
                env=env, cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT,
            ))
    return procs, out_dir


def collect(handle, timeout: float = 600):
    """Wait for the ranks; once one fails the others (left waiting in a
    collective) are stopped after a few seconds."""
    procs, out_dir = handle
    world = len(procs)
    deadline = time.time() + timeout
    failed_at = None
    while any(p.poll() is None for p in procs):
        now = time.time()
        if failed_at is None and any(p.returncode not in (None, 0)
                                     for p in procs):
            failed_at = now
        if now > deadline or (failed_at is not None and now > failed_at + 5):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if failed_at is None:
                raise subprocess.TimeoutExpired(procs[0].args, timeout)
            break
        time.sleep(0.05)
    logs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            logs.append(f.read())
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


# -- the in-flight engine, speculation and training over a mesh -------------


def _engine_params(plan, key="engine_params"):
    return _params(dict(params_npz=plan[key]))


def _heads(plan, key):
    from whisper_ipa_torch.models import medusa_from_numpy

    return medusa_from_numpy(plan[key])


def _spy_chunks(eng):
    """Record every host sync this rank's engine returns (each rank
    gathers its data group's slots) and the rounds each chunk asked for."""
    seen, asked = [], []
    run = eng._run_chunk

    def spy(rounds):
        asked.append(rounds)
        host = run(rounds)
        seen.append(host.copy())
        return host

    eng._run_chunk = spy
    return seen, asked


def sc_multipos_tp(plan):
    """``decode_step_multipos_hidden`` and ``decode_step_block`` at TP 2
    from one cache state (the float and the int8 cross cache): logits,
    hidden states and the gathered self K/V."""
    import torch

    from whisper_ipa_torch.models import (decode_step_block,
                                          decode_step_multipos_hidden,
                                          init_cache)
    from whisper_ipa_torch.parallel import distributed as D
    from whisper_ipa_torch.parallel import make_mesh, shard_params

    cfg = _cfg(plan["engine_cfg"])
    mesh = make_mesh(model=2)
    tp = mesh.tp
    params = shard_params(mesh, _engine_params(plan), tensor_parallel=True)
    mp = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in plan["mp"].items()}
    out = {}
    for kv_int8 in (False, True):
        for name in ("multipos", "block"):
            cache = init_cache(params, cfg, mp["feats"], max_len=mp["n_ctx"],
                               cross_kv_int8=kv_int8, tp=tp)
            d = cache.self_k.shape[-1]
            for buf, full in ((cache.self_k, mp["self_k"]),
                              (cache.self_v, mp["self_v"])):
                buf.copy_(full[..., tp.rank * d:(tp.rank + 1) * d])
            with torch.inference_mode():
                if name == "multipos":
                    logits, cache, hidden = decode_step_multipos_hidden(
                        params, cfg, mp["tokens"], cache, mp["pos"], tp=tp)
                else:
                    logits, cache, hidden = decode_step_block(
                        params, cfg, mp["block_tokens"], cache,
                        mp["block_pos"], mp["frontier"], mp["mask"],
                        write_len=mp["write_len"], tp=tp)
                k = D.all_gather(cache.self_k, tp.group, dim=3)
                v = D.all_gather(cache.self_v, tp.group, dim=3)
            out[f"{name} int8={kv_int8}"] = dict(
                logits=logits.numpy(), hidden=hidden.numpy(), self_k=k.numpy(),
                self_v=v.numpy(), local=tuple(cache.self_k.shape),
                cross=tuple(cache.cross_k.shape))
    return out


def _engine_extra(plan, mode):
    from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE

    if mode == "ngram":
        return dict(draft_k=3)
    if mode == "model":  # the target itself, replicated whole as the draft
        return dict(draft_k=3, draft_params=_engine_params(plan),
                    draft_cfg=_cfg(plan["engine_cfg"]))
    if mode == "medusa":
        return dict(medusa_params=_heads(plan, "heads3"))
    if mode == "tree":
        return dict(medusa_params=_heads(plan, "heads4"),
                    medusa_tree=DEFAULT_TREE)
    return {}


def sc_engine(plan, data, model, mode, slots, clips, gap=0.02, **engine_kw):
    """The engine over a data x model mesh (``engine_kw``: more of its
    options): rank 0 submits the clips ``gap`` s apart (more requests
    than slots, joins into a running batch) while the others follow.
    Returns rank 0's tokens, every rank's host syncs, the rounds its
    chunks asked for, its local state's shapes and stats."""
    import time

    from whisper_ipa_torch.parallel import make_mesh
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher
    from whisper_ipa_torch.tokenizer import get_tokenizer

    cfg = _cfg(plan["engine_cfg"])
    mesh = make_mesh(data=data, model=model)
    eng = ContinuousBatcher(
        _engine_params(plan), cfg, device="cpu", slots=slots,
        max_new_tokens=plan["max_new"], steps_per_sync=2, language="en",
        tokenizer=get_tokenizer(multilingual=True, language="en"),
        mesh=mesh, tensor_parallel=model > 1, **_engine_extra(plan, mode),
        **engine_kw)
    shapes = dict(self_k=tuple(eng.cache.self_k.shape),
                  cross_k=tuple(eng.cache.cross_k.shape),
                  lens=tuple(eng.lens.shape),
                  query_w=tuple(eng.params["decoder"]["blocks"][0]["attn"]
                                ["query"]["w"].shape))
    if eng.draft_cache is not None:
        shapes["draft_self_k"] = tuple(eng.draft_cache.self_k.shape)
    if eng.hidden_frontier is not None:
        shapes["hidden_frontier"] = tuple(eng.hidden_frontier.shape)
    seen, asked = _spy_chunks(eng)
    tokens = None
    if eng._thread is not None:
        futs = []
        for k in clips:
            futs.append(eng.submit(plan["clips"][k]))
            time.sleep(gap)
        tokens = [f.result(timeout=300)["tokens"] for f in futs]
        eng.close()
        assert not eng._thread.is_alive()
    else:
        eng.follow()
    return dict(tokens=tokens, syncs=seen, asked=sum(asked), shapes=shapes,
                stats=eng.stats())


def sc_engine_leader_fails(plan, inside: bool):
    """The engine at TP 2 whose rank 0 fails, between commands (its first
    retire raises, after the chunk's sync) or inside one (its first chunk
    raises before any collective, while rank 1 runs the chunk's). Returns
    rank 0's request error and whether its process group is left, and the
    exception rank 1's ``follow()`` raised."""
    import time

    import torch.distributed as dist

    from whisper_ipa_torch.parallel import make_mesh
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher
    from whisper_ipa_torch.tokenizer import get_tokenizer

    eng = ContinuousBatcher(
        _engine_params(plan), _cfg(plan["engine_cfg"]), device="cpu",
        slots=2, max_new_tokens=plan["max_new"], steps_per_sync=2,
        language="en", tokenizer=get_tokenizer(multilingual=True,
                                               language="en"),
        mesh=make_mesh(model=2), tensor_parallel=True)
    if eng._thread is None:
        t0 = time.time()
        try:
            eng.follow()
            raised = None
        except Exception as e:  # what releases this rank
            raised = f"{type(e).__name__}: {e}"
        return dict(raised=raised, seconds=time.time() - t0)

    def fail(*args):
        raise RuntimeError("injected failure")

    if inside:
        eng._run_chunk = fail
    else:
        eng._retire = fail
    try:
        eng.submit(plan["clips"][0]).result(timeout=120)
        error = None
    except RuntimeError as e:
        error = str(e)
    eng._thread.join(timeout=30)
    return dict(error=error, alive=eng._thread.is_alive(),
                group=dist.is_initialized())


def sc_service_spec(plan, mode):
    """The micro-batch service at TP 2 with speculative decoding (a draft
    model, Medusa chain or tree), f32: rank 0's texts."""
    from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE
    from whisper_ipa_torch.parallel import make_mesh
    from whisper_ipa_torch.serve import TranscriptionService
    from whisper_ipa_torch.tokenizer import get_tokenizer

    cfg = _cfg(plan["engine_cfg"])
    mesh = make_mesh(model=2)
    extra = dict(draft_params=_engine_params(plan, "draft_params"),
                 draft_cfg=cfg, draft_k=3)
    if mode != "draft":
        extra = dict(medusa_params=_heads(plan, "heads4"),
                     medusa_tree=DEFAULT_TREE if mode == "tree" else None)
    svc = TranscriptionService(
        _engine_params(plan), cfg, device="cpu", batch_size=2,
        max_wait_ms=200, bf16=False, mesh=mesh, tensor_parallel=True,
        tokenizer=get_tokenizer(multilingual=True, language="en"), **extra)
    if svc._thread is None:
        svc.follow()
        return None
    futs = [svc.submit(plan["clips"][k]) for k in plan["service_clips"]]
    texts = [f.result(timeout=300)["text"] for f in futs]
    svc.close()
    return dict(texts=texts, batches=svc.stats()["batches"])


def _wait_ready(plan, timeout: float = 300) -> None:
    """Wait for the test to write the training cases' inputs."""
    deadline = time.time() + timeout
    while not os.path.exists(plan["ready"]):
        if time.time() > deadline:
            raise TimeoutError(f"no {plan['ready']} after {timeout} s")
        time.sleep(0.05)


def _train_losses(out: str) -> dict:
    import csv

    with open(os.path.join(out, "training_log.csv")) as f:
        return {int(r["step"]): float(r["loss"]) for r in csv.DictReader(f)}


def _run_train(plan, out, **kw):
    from whisper_ipa_torch.train.loop import train

    _wait_ready(plan)
    return train("test-tiny", plan["dataset"], plan["dataset"], out,
                 batch_size=2, learning_rate=1e-4, validate_every=0,
                 save_every=0, weights=plan["weights"], final_validate=False,
                 device="cpu", seed=3, **kw)


def sc_cache_encoder(plan, kind, out_dir):
    """train(cache_encoder=True) under TP 2, or FSDP or DP over data 2, 2
    steps, each rank with its own output directory (no shared
    filesystem): rank 0's losses and the feature files each rank holds."""
    import torch.distributed as dist

    rank = dist.get_rank()
    out = os.path.join(out_dir, f"rank{rank}")
    kw = {"tp": dict(tensor_parallel=2, data_parallel=False),
          "fsdp": dict(fsdp=True), "dp": {}}[kind]
    _run_train(plan, out, num_steps=2, cache_encoder=True, **kw)
    cache = os.path.join(out, "encoder_cache")
    feats = {f: np.load(os.path.join(cache, f)) for f in sorted(os.listdir(cache))}
    return dict(feats=feats,
                losses=_train_losses(out) if rank == 0 else None)


def sc_resume(plan, kind, out_dir):
    """Resume one step from a 2-step checkpoint, twice: from a directory
    both ranks share, and with a directory a rank where only rank 0's
    holds the checkpoint (it broadcasts its restored state). Rank 0's
    step-3 losses and whether the rank saw the ranks disagree."""
    import contextlib
    import io
    import shutil

    import torch.distributed as dist

    _wait_ready(plan)
    rank = dist.get_rank()
    kw = {"dp": {}, "zero1": dict(zero1=True), "fsdp": dict(fsdp=True)}[kind]
    shared = os.path.join(out_dir, "shared")
    own = os.path.join(out_dir, f"own{rank}")
    if rank == 0:
        shutil.copytree(plan["resume_run"], shared)
        shutil.copytree(plan["resume_run"], own)
    else:
        os.makedirs(own)
    dist.barrier()
    out = {}
    for name, path in (("shared", shared), ("own", own)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _run_train(plan, path, num_steps=3, resume=True, **kw)
        print(buf.getvalue())
        dist.barrier()
        out[name] = dict(
            losses=_train_losses(path) if rank == 0 else None,
            broadcast="broadcasting rank 0's restored state" in buf.getvalue())
    return out


def sc_serve_continuous(plan, flags=()):
    """cli.serve --continuous --dp 2 (f32) with ``flags``: rank 0 answers
    one request over HTTP while rank 1 follows."""
    import json
    import threading
    import urllib.request

    from whisper_ipa_torch.cli import serve as serve_cli
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher

    def f32_engine(*args, **kw):  # the CLI passes bf16=True
        return ContinuousBatcher(*args, **dict(kw, bf16=False))

    serve_cli.ContinuousBatcher = f32_engine
    _wait_ready(plan)
    argv = ["--model", "test-tiny", "--weights", plan["weights"], "--port",
            "0", "--device", "cpu", "--continuous", "--batch-size", "4",
            "--max-new-tokens", str(plan["max_new"]), "--dp", "2",
            *flags]
    server, service = serve_cli.build_server(argv)
    local = tuple(service.cache.self_k.shape)
    if server is None:
        service.follow()
        return dict(local=local)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    req = urllib.request.Request(
        f"http://{host}:{port}/transcribe",
        data=json.dumps({"path": plan["wavs"][0]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        answer = json.loads(r.read())
    server.shutdown()
    server.server_close()
    service.close()
    return dict(answer=answer, local=local)


SCENARIOS = {
    "collectives": sc_collectives,
    "train": sc_train,
    "decode": sc_decode,
    "validate": sc_validate,
    "checkpoints": sc_checkpoints,
    "service": sc_service,
    "train_cli": sc_train_cli,
    "multipos_tp": sc_multipos_tp,
    "engine": sc_engine,
    "engine_leader_fails": sc_engine_leader_fails,
    "service_spec": sc_service_spec,
    "cache_encoder": sc_cache_encoder,
    "resume": sc_resume,
    "serve_continuous": sc_serve_continuous,
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
        if name in ("checkpoints", "train_cli", "cache_encoder", "resume"):
            kwargs = dict(kwargs, out_dir=os.path.join(out_dir, key))
        results[key] = SCENARIOS[name](plan, **kwargs)
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    if torch.distributed.is_initialized():  # a failed leader tore it down
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
