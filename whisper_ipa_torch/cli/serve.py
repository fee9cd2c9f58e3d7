"""CLI: HTTP transcription server over the micro-batching service or the
in-flight engine.

Counterpart of ``whisper_ipa_tpu/cli/serve.py`` over the port's
``serve.TranscriptionService`` or, with ``--continuous``,
``serve_continuous.ContinuousBatcher``, on one device or over a mesh.

POST /transcribe with a WAV body (or JSON {"path": ...}) returns the
service's result: {"text", "segments", "latency_sec"}, or the engine's
{"text", "tokens", "n_windows", "latency_sec", "queue_sec", "ttft_sec",
"truncated", "timed_out"}. POST /transcribe_stream streams NDJSON over
chunked transfer: one {"partial": ...} line per decoded 30 s window (the
service) or per decoded token (the engine), then a final {"final": ...}
line. GET /healthz and /stats for operations. A handler error is a 500;
the engine's ``EngineOverloaded`` (``--max-pending`` requests already
waiting) is a 503.

  python -m whisper_ipa_torch.cli.serve --model small --port 8080 \\
      --checkpoint checkpoints/whisper-ipa/best-checkpoint
  python -m whisper_ipa_torch.cli.serve --model small --continuous \\
      --batch-size 16 --max-new-tokens 128 --max-pending 64 --warmup

``build_server(argv)`` builds the service and a bound server without
serving, so a caller can run ``serve_forever`` in a thread and stop it with
``shutdown()``.

``--beam-size`` decodes each batch with beam search. ``--continuous``
takes the reference's engine settings: bf16 activations, the int8 cross
cache, ``--batch-size`` slots, ``--max-new-tokens``, ``--steps-per-sync``,
``--adaptive-sync``, ``--no-join-fast-sync``, ``--max-pending``, and with
``--warmup`` every kernel built before binding; it refuses ``--beam-size``,
``--kv-int4`` and ``--tp`` with ``--quant-bits``, as the reference does.

``--draft-model`` turns on speculative decoding, in the service and in
the engine alike (tokens equal to greedy decoding): a model name (e.g.
``tiny``, its weights from ``--draft-weights`` and a trained checkpoint
from ``--draft-checkpoint``, ``--draft-k`` tokens a round), ``ngram``
(prompt lookup over ``--draft-k`` tokens: its drafts serve only in the
in-flight engine, so the service decodes plainly, as the reference's
does), or ``medusa`` (heads from ``--medusa-weights``, untrained
``--draft-k`` heads without it; ``--medusa-tree`` verifies a tree,
optimized from the heads' accuracy file where ``cli.train_medusa`` wrote
one).

  python -m whisper_ipa_torch.cli.serve --model small --continuous \
      --draft-model medusa --medusa-weights heads.safetensors --medusa-tree

``--dp`` / ``--tp`` serve over a mesh: launch ``--dp x --tp`` processes
with torchrun (one a device); rank 0 binds the server and the others
follow its batches (``TranscriptionService``) or its engine's commands
(``--continuous``: the slots shard over 'data', and with ``--tp`` the
weights over 'model'; ``--batch-size`` must divide by ``--dp``). With
``--dp`` and ``--quant-bits`` every rank holds the quantized weights.

  torchrun --nproc-per-node 2 -m whisper_ipa_torch.cli.serve \
      --model small --tp 2 --port 8080
  torchrun --nproc-per-node 2 -m whisper_ipa_torch.cli.serve \
      --model small --continuous --tp 2 --port 8080

The reference's ``--no-aot-cache`` parses and does nothing: CUDA has no
executable cache to switch off (item 14).
"""

import argparse
import json
import os
import queue
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch.distributed as dist

from ..audio import load_audio_bytes
from ..config import get_config
from ..decode.medusa_tree import DEFAULT_TREE, tree_for_heads
from ..models import load_checkpoint_auto
from ..models.medusa import init_medusa_params, load_medusa
from ..ops.quant import quantize_params
from ..parallel import initialize, make_mesh
from ..serve import TranscriptionService
from ..serve_continuous import ContinuousBatcher, EngineOverloaded
from ..train.loop import load_or_init_params, resolve_device
from . import add_device_flag, add_overlay_flags


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": "not found"})

        def _read_audio(self, body):
            if self.headers.get("Content-Type", "").startswith(
                "application/json"
            ):
                return json.loads(body)["path"]
            return load_audio_bytes(body)

        def _write_chunk(self, obj):
            data = (json.dumps(obj, ensure_ascii=False) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()

        def do_POST(self):
            if self.path not in ("/transcribe", "/transcribe_stream"):
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                audio = self._read_audio(body)
                if self.path == "/transcribe":
                    self._send(200, service.transcribe(audio))
                    return
                # the service calls on_partial for every window before it
                # resolves the future, so once the future is done and the
                # queue drained, every partial line has been written
                partials: "queue.Queue" = queue.Queue()
                fut = service.submit(audio, on_partial=partials.put)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while not (fut.done() and partials.empty()):
                    try:
                        self._write_chunk(
                            {"partial": partials.get(timeout=0.05)}
                        )
                    except queue.Empty:
                        continue
                self._write_chunk({"final": fut.result()})
                self.wfile.write(b"0\r\n\r\n")
            except Exception as e:  # the request's boundary: report, serve on
                code = 503 if isinstance(e, EngineOverloaded) else 500
                try:
                    self._send(code, {"error": str(e)})
                except OSError:
                    pass  # the client is gone, or a stream already started

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IPA transcription server")
    p.add_argument("--model", default="small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--language", default="en")
    p.add_argument(
        "--no-aot-cache", dest="aot_cache", action="store_false",
        default=True,
        help="accepted for the reference's launch lines and inert: the "
        "kernels are built once by nvcc, and CUDA has no executable cache "
        "to switch off",
    )
    p.add_argument(
        "--kv-int4", action="store_true",
        help="nibble-packed int4 cross-KV cache: half of int8's cache memory",
    )
    p.add_argument(
        "--quant-bits", type=int, default=None, choices=(4, 8),
        help="weight-only quantization: 8 (per-channel int8) or 4 "
        "(group-scaled packed int4)",
    )
    p.add_argument(
        "--warmup", action="store_true",
        help="run one dummy batch before binding (builds the kernels; the "
        "continuous engine also runs each of its device functions once)",
    )
    p.add_argument("--beam-size", type=int, default=None,
                   help="beam-search decoding width (default: greedy)")
    p.add_argument(
        "--continuous", action="store_true",
        help="in-flight batching engine (serve_continuous): requests join "
        "a running batch; per-token streaming; 30 s windows in turn",
    )
    p.add_argument(
        "--draft-model", default=None,
        help="speculative decoding: a draft model name (e.g. tiny), "
        "'ngram' (prompt lookup), or 'medusa' (one-shot heads from "
        "--medusa-weights); the tokens stay those of greedy decoding",
    )
    p.add_argument(
        "--medusa-tree", action="store_true",
        help="tree-structured Medusa verification "
        "(decode/medusa_tree.DEFAULT_TREE, or the tree optimized from the "
        "heads' accuracy file)",
    )
    p.add_argument(
        "--medusa-weights", default=None,
        help="safetensors file of Medusa heads (cli.train_medusa) for "
        "--draft-model medusa",
    )
    p.add_argument("--draft-weights", default=None,
                   help="pretrained safetensors of the draft model")
    p.add_argument(
        "--draft-checkpoint", default=None,
        help="trained draft checkpoint (e.g. cli.distill_draft's) over the "
        "draft model; the overlay mode comes from its run's "
        "training_config.json",
    )
    p.add_argument("--draft-k", type=int, default=4,
                   help="draft tokens a round (the untrained heads' count "
                   "for --draft-model medusa)")
    p.add_argument("--max-new-tokens", type=int, default=128,
                   help="continuous engine: token budget of a window")
    p.add_argument("--steps-per-sync", type=int, default=4,
                   help="continuous engine: decode steps between host syncs")
    p.add_argument(
        "--adaptive-sync", action="store_true",
        help="continuous engine: long decode chunks when no joins are "
        "pending (throughput knob; raises worst-case join latency)",
    )
    p.add_argument(
        "--no-join-fast-sync", dest="join_fast_sync",
        action="store_false", default=True,
        help="continuous engine: no 1-round chunk after a join (the TTFT "
        "fast path)",
    )
    p.add_argument(
        "--max-pending", type=int, default=None,
        help="continuous engine: answer 503 when this many requests are "
        "already waiting (backpressure over unbounded queueing latency)",
    )
    p.add_argument(
        "--dp", type=int, default=1,
        help="data-parallel ways: shard each batch over the mesh's 'data' "
        "axis (a torchrun world of --dp x --tp processes)",
    )
    p.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel ways: shard the weights over the mesh's "
        "'model' axis",
    )
    add_overlay_flags(p)
    add_device_flag(p)
    return p


def _refuse_continuous(args) -> None:
    """The reference's refusals of the engine's flag combinations."""
    if args.tp > 1 and args.quant_bits is not None:
        raise SystemExit(
            "--continuous --tp shards float weights (TP_RULES); "
            "drop --quant-bits or use the micro-batch service"
        )
    if args.beam_size:
        raise SystemExit("--continuous is greedy-only (no beam)")
    if args.kv_int4:
        raise SystemExit(
            "--continuous supports int8 cross-KV only (the engine's "
            "persistent cache has no int4 path); drop --kv-int4"
        )


def _mesh(args, device):
    """The --dp x --tp mesh over the torchrun world (None for one
    process): checks the world size and joins the process group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.dp * args.tp != world:
        raise SystemExit(
            f"--dp {args.dp} x --tp {args.tp} must equal the number of "
            f"processes ({world}); launch with torchrun --nproc-per-node "
            f"{args.dp * args.tp}"
        )
    if world == 1:
        return None
    if not dist.is_initialized():
        initialize(device=device)
    return make_mesh(data=args.dp, model=args.tp)


def build_server(argv=None):
    """Parse the flags, load the model, start the service and bind the
    server; returns (server, service) without serving. Over a mesh only
    rank 0 binds a server: the other ranks get (None, service) and run
    ``service.follow()``."""
    args = build_parser().parse_args(argv)
    if args.continuous:
        _refuse_continuous(args)
    if args.medusa_tree and args.draft_model != "medusa":
        raise SystemExit("--medusa-tree requires --draft-model medusa")
    device = resolve_device(args.device)
    mesh = _mesh(args, device)
    if mesh is not None:
        device = mesh.device
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, args.weights, device=device)
    if args.checkpoint:
        params, n = load_checkpoint_auto(
            args.checkpoint, params, args.full_ckpt
        )
        print(f"Loaded {n} tensors from {args.checkpoint}")
    draft_params = draft_cfg = medusa_params = medusa_tree = None
    if args.draft_model == "medusa":
        if args.medusa_weights:
            medusa_params = load_medusa(args.medusa_weights, device=device)
        else:
            medusa_params = init_medusa_params(cfg, n_heads=args.draft_k,
                                               device=device)
            print(
                "WARNING: untrained Medusa heads (no --medusa-weights): "
                "output stays exact but speculation will rarely accept"
            )
        if args.medusa_tree:
            medusa_tree = (tree_for_heads(args.medusa_weights)
                           if args.medusa_weights else DEFAULT_TREE)
    elif args.draft_model and args.draft_model != "ngram":
        draft_cfg = get_config(args.draft_model)
        draft_params = load_or_init_params(
            args.draft_model, draft_cfg, args.draft_weights, device=device
        )
        if args.draft_checkpoint:
            draft_params, n = load_checkpoint_auto(
                args.draft_checkpoint, draft_params
            )
            print(f"Loaded {n} draft tensors from {args.draft_checkpoint}")
    if args.continuous:
        if args.quant_bits is not None:
            params = quantize_params(params, bits=args.quant_bits)
        # the service's serving defaults: bf16 activations, int8 cross cache
        service = ContinuousBatcher(
            params,
            cfg,
            device=device,
            slots=args.batch_size,
            max_new_tokens=args.max_new_tokens,
            steps_per_sync=args.steps_per_sync,
            join_fast_sync=args.join_fast_sync,
            adaptive_sync=args.adaptive_sync,
            language=args.language,
            bf16=True,
            kv_int8=True,
            draft_k=args.draft_k if args.draft_model else 0,
            draft_params=draft_params,
            draft_cfg=draft_cfg,
            medusa_params=medusa_params,
            medusa_tree=medusa_tree,
            max_pending=args.max_pending,
            mesh=mesh,
            tensor_parallel=args.tp > 1,
            # a long-lived server builds every kernel before binding
            prewarm=args.warmup,
        )
    else:
        service = TranscriptionService(
            params,
            cfg,
            device=device,
            batch_size=args.batch_size,
            max_wait_ms=args.max_wait_ms,
            language=args.language,
            beam_size=args.beam_size,
            quant_bits=args.quant_bits,
            kv_int4=args.kv_int4,
            draft_params=draft_params,
            draft_cfg=draft_cfg,
            draft_k=args.draft_k,
            medusa_params=medusa_params,
            medusa_tree=medusa_tree,
            mesh=mesh,
            tensor_parallel=args.tp > 1,
        )
    if mesh is not None and dist.get_rank() != 0:
        return None, service
    try:
        if args.warmup:
            print("Warming up (one dummy batch)...")
            service.transcribe(np.zeros(16000, np.float32))
            print("Warmup done.")
        server = ThreadingHTTPServer(
            (args.host, args.port), make_handler(service)
        )
    except BaseException:
        service.close()
        raise
    host, port = server.server_address[:2]
    print(f"Serving on http://{host}:{port} (model {cfg.name}, {device})")
    return server, service


def main(argv=None):
    server, service = build_server(argv)
    if server is None:
        service.follow()  # a follower rank, until rank 0 closes
        return
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
