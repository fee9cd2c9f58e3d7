"""PyTorch port: ``whisper_ipa_torch.parallel`` against ``whisper_ipa_tpu.parallel``.

Single process: the sharding rules (``TP_RULES``, ``spec_for_param``,
``zero1_spec``) and the shard shape of every tensor under
``shard_params``, ``fsdp_param_shardings`` and ``opt_state_shardings``,
held to the JAX package's ``NamedSharding`` on its 8 virtual CPU devices.

Several processes (gloo on the CPU, ``tests/torch_ranks.py``): worlds of 2
and 4 ranks run DP, TP, dp x tp, ZeRO-1 (with accumulation, bf16 first
moments and the frozen encoder), FSDP and FSDP + TP training, and TP
greedy / beam / int8-cache decoding, each held to the JAX package on the
same test-tiny weights (n_audio_ctx = n_text_ctx = 32) and seeded inputs:
losses within 1e-5 relative, parameters within 1e-5 absolute, tokens
equal. The dp 2 x tp 2 world also meets the JAX dp 4 x tp 2 mesh on the
inputs of ``__graft_entry__.dryrun_multichip`` (loss 10.8322).
"""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.tree_util import GetAttrKey, tree_flatten_with_path

from whisper_ipa_tpu import parallel as jpar
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import flatten_params as jax_flatten
from whisper_ipa_tpu.parallel.mesh import _trailing_tree_path
from whisper_ipa_tpu.train import create_train_state as jax_create_state
from whisper_ipa_tpu.train import train_step as jax_train_step
from whisper_ipa_torch import parallel as tpar
from whisper_ipa_torch.models import params_from_numpy
from whisper_ipa_torch.parallel.mesh import NamedSharding, P
from whisper_ipa_torch.train import create_train_state

import torch_ranks

torch.set_num_threads(1)

FIELDS = dict(n_audio_ctx=32, n_text_ctx=32)
JCFG = replace(JAX_CONFIGS["test-tiny"], **FIELDS)
EOT = 50257
RTOL_LOSS, ATOL_PARAM = 1e-5, 1e-5


def _batch(seed, n, uneven=True):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((n, 64, JCFG.n_mels)).astype(np.float32)
    tokens = np.tile([[50258, 50259, 50359, 50363, 100, 200, 300, EOT, EOT]],
                     (n, 1)).astype(np.int32)
    if uneven:  # rows with 1, 2 or 3 text tokens: unequal counts per rank
        for i in range(n):
            tokens[i, 5 + i % 3:] = EOT
    return dict(mel=mel, tokens=tokens)


def _mc_batch():
    """``dryrun_multichip``'s inputs (batch 8, seed 0)."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((8, JCFG.n_audio_ctx * 2, JCFG.n_mels)).astype(
        np.float32)
    tokens = np.tile([[50258, 50259, 50359, 50363, 100, 200, EOT, EOT]],
                     (8, 1)).astype(np.int32)
    return dict(mel=mel, tokens=tokens)


# lr 1e-4: AdamW's first updates are about lr * g / |g|, so an element
# whose gradient is near zero moves by up to lr when the ranks sum the
# gradient in another order than one device does; at 1e-4 that stays
# under the 1e-5 bound while a wrong gradient still moves elements by ~lr
FULL_FT = dict(learning_rate=1e-4, freeze_encoder=False)
ZERO1_VARIANT = dict(learning_rate=1e-4, freeze_encoder=True, accum_steps=2,
                     mu_dtype="bfloat16")
MC = dict(learning_rate=1e-4, freeze_encoder=True)
DECODE = {
    "greedy": dict(language="en", without_timestamps=True, sample_len=4),
    "beam": dict(language="en", without_timestamps=True, sample_len=4,
                 beam_size=3, length_penalty=1.0),
    "int8": dict(language="en", without_timestamps=True, sample_len=4,
                 kv_int8=True),
    "detect": dict(language=None, sample_len=6),
}


def _jax_train(batch, steps, kw, mesh=None):
    params = jax_init_params(JCFG, seed=0)
    if mesh is not None:
        params = jpar.shard_params(mesh, params, tensor_parallel=True)
    state, tx = jax_create_state(params, **kw)
    mel, tokens = jnp.asarray(batch["mel"]), jnp.asarray(batch["tokens"])
    if mesh is not None:
        mel, tokens = jpar.shard_batch(mesh, mel, tokens)
    losses = []
    for _ in range(steps):
        state, loss = jax_train_step(state, mel, tokens, JCFG, tx, EOT,
                                     freeze_encoder=kw["freeze_encoder"])
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in
                    jax_flatten(jax.device_get(state.params)).items()}


def _train(key, kind, data, model, steps, kw, batch):
    return (key, "train", dict(kind=kind, data=data, model=model, steps=steps,
                               train_kw=kw, batch=batch))


WORLD2 = [
    ("collectives", "collectives", {}),
    _train("dp2", "dp", 2, 1, 2, FULL_FT, "batch4"),
    _train("tp2", "dp", 1, 2, 2, FULL_FT, "batch4"),
    _train("zero1_variant", "zero1", 2, 1, 4, ZERO1_VARIANT, "batch8"),
    _train("fsdp2", "fsdp", 2, 1, 2, FULL_FT, "batch4"),
    ("decode_tp2", "decode", dict(model=2, options=DECODE)),
]
WORLD4 = [
    ("collectives", "collectives", {}),
    _train("dp2_tp2", "dp", 2, 2, 2, FULL_FT, "batch4"),
    _train("zero1_dp2_tp2", "zero1", 2, 2, 2, FULL_FT, "batch4"),
    _train("fsdp_dp2_tp2", "fsdp", 2, 2, 2, FULL_FT, "batch4"),
    _train("multichip", "dp", 2, 2, 1, MC, "mc"),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds run while the JAX references compute here."""
    root = tmp_path_factory.mktemp("parallel")
    npz = str(root / "params.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     jax_flatten(jax_init_params(JCFG, seed=0)).items()})
    rng = np.random.default_rng(0)
    plan = dict(params_npz=npz, cfg=FIELDS, eot=EOT,
                batch4=_batch(3, 4), batch8=_batch(5, 8), mc=_mc_batch(),
                decode_mel=rng.standard_normal((2, 64, JCFG.n_mels)).astype(
                    np.float32))
    h2 = torch_ranks.start(2, dict(plan, scenarios=WORLD2), str(root / "w2"))
    h4 = torch_ranks.start(4, dict(plan, scenarios=WORLD4), str(root / "w4"))
    ref = {
        "full_ft": _jax_train(plan["batch4"], 2, FULL_FT),
        "zero1_variant": _jax_train(plan["batch8"], 4, ZERO1_VARIANT),
        "mc_single": _jax_train(plan["mc"], 1, MC),
        "mc_mesh": _jax_train(plan["mc"], 1, MC, jpar.make_mesh(model=2)),
    }
    from whisper_ipa_tpu.decode import DecodingOptions, decode
    from whisper_ipa_tpu.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=True, language="en")
    jp = jax_init_params(JCFG, seed=0)
    ref["decode"] = {
        name: [r.tokens for r in decode(jp, JCFG, jnp.asarray(plan["decode_mel"]),
                                        DecodingOptions(**kw), tokenizer=tok)]
        for name, kw in DECODE.items()
    }
    w2, _ = torch_ranks.collect(h2)
    w4, _ = torch_ranks.collect(h4)
    return dict(w2=w2, w4=w4, ref=ref)


# -- single process: rules and shard shapes --------------------------------


def _fake_mesh(data, model):
    return SimpleNamespace(shape={"data": data, "model": model})


def _names():
    return list(jax_flatten(jax_init_params(JCFG, seed=0)))


def test_tp_rules_match():
    assert [(pat, tuple(spec)) for pat, spec in tpar.TP_RULES] == [
        (pat, tuple(spec)) for pat, spec in jpar.TP_RULES]


def test_spec_for_param_matches():
    names = _names() + ["encoder.blocks.0.attn.out.b", "decoder.ln.g"]
    for n in names:
        assert tuple(tpar.spec_for_param(n)) == tuple(jpar.spec_for_param(n)), n


@pytest.mark.parametrize("data", [2, 4, 8])
def test_zero1_spec_matches(data):
    from jax.sharding import PartitionSpec as JP

    shapes = [(), (7,), (64,), (384, 1536), (1536, 384), (7, 5), (3, 64, 64),
              (51865, 64), (64, 256), (256, 64)]
    bases = [(P(), JP()), (P(None, "model"), JP(None, "model")),
             (P("model", None), JP("model", None)), (P("model"), JP("model"))]
    for shape in shapes:
        for ours, theirs in bases:
            if len(ours) > len(shape):
                continue
            got = tpar.zero1_spec(shape, data, ours)
            want = jpar.zero1_spec(shape, data, theirs)
            assert tuple(got) == tuple(want), (shape, data, ours)


def _jax_shard_shapes(tree_sh, params):
    flat_sh = jax_flatten(tree_sh)
    flat_p = jax_flatten(params)
    return {k: sh.shard_shape(flat_p[k].shape) for k, sh in flat_sh.items()}


def _port_shard_shapes(tree_sh, params):
    from whisper_ipa_torch.models.convert import flatten_params

    flat_sh = flatten_params(tree_sh)
    flat_p = flatten_params(params)
    return {k: sh.shard_shape(tuple(flat_p[k].shape)) for k, sh in flat_sh.items()}


@pytest.mark.parametrize("kind", ["param", "fsdp", "fsdp_tp"])
def test_param_shard_shapes_match(kind):
    jp = jax_init_params(JCFG, seed=0)
    tp_params = params_from_numpy({k: np.asarray(v) for k, v in jax_flatten(jp).items()})
    jmesh = jpar.make_mesh(model=2)  # data 4 x model 2
    mesh = _fake_mesh(4, 2)
    if kind == "param":
        want = _jax_shard_shapes(jpar.param_shardings(jmesh, jp), jp)
        got = _port_shard_shapes(tpar.param_shardings(mesh, tp_params), tp_params)
    else:
        tp = kind == "fsdp_tp"
        want = _jax_shard_shapes(
            jpar.fsdp_param_shardings(jmesh, jp, tensor_parallel=tp), jp)
        got = _port_shard_shapes(
            tpar.fsdp_param_shardings(mesh, tp_params, tensor_parallel=tp),
            tp_params)
    assert got == want


def _jax_opt_shapes(tx, jp, shardings):
    shapes = jax.eval_shape(tx.init, jp)
    leaves, _ = tree_flatten_with_path(shapes)
    sh_leaves = jax.tree.leaves(shardings)
    out = {}
    for (path, leaf), sh in zip(leaves, sh_leaves):
        fields = [e.name for e in path if isinstance(e, GetAttrKey)]
        field = next((f for f in fields if f in ("mu", "nu", "acc_grads")), None)
        if field is None or not getattr(leaf, "shape", ()):
            continue
        tail = _trailing_tree_path(path)
        out[(field, tail)] = sh.shard_shape(leaf.shape)
    return out


@pytest.mark.parametrize("tp,zero1,frozen,accum", [
    (False, True, True, 1), (True, False, False, 1), (True, True, False, 2),
    (False, True, False, 2),
])
def test_opt_state_shard_shapes_match(tp, zero1, frozen, accum):
    from whisper_ipa_tpu.train.optimizer import make_optimizer

    jp = jax_init_params(JCFG, seed=0)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jp).items()}
    tx_j = make_optimizer(learning_rate=1e-3, freeze_encoder=frozen,
                          accum_steps=accum)
    want = _jax_opt_shapes(
        tx_j, jp, jpar.opt_state_shardings(jpar.make_mesh(model=2), tx_j, jp,
                                           tensor_parallel=tp, zero1=zero1))
    _, tx = create_train_state(params_from_numpy(flat), learning_rate=1e-3,
                               freeze_encoder=frozen, accum_steps=accum)
    osh = tpar.opt_state_shardings(_fake_mesh(4, 2), tx, params_from_numpy(flat),
                                   tensor_parallel=tp, zero1=zero1)
    got = {}
    for field in ("mu", "nu", "acc_grads"):
        for n, sh in getattr(osh, field).items():
            got[(field, n)] = sh.shard_shape(flat[n].shape)
    # the reference's frozen-encoder acc_grads cover every parameter; the
    # port keeps the trainable ones (its checkpoint writes zeros for the rest)
    want = {k: v for k, v in want.items() if k in got or k[0] != "acc_grads"}
    assert got == want


def test_sharding_blocks_cut_and_shape():
    mesh = SimpleNamespace(shape={"data": 2, "model": 2},
                           index=lambda a: {"data": 1, "model": 0}[a])
    t = torch.arange(8 * 6).reshape(8, 6)
    sh = NamedSharding(mesh, P("data", "model"))
    block = sh.local_block(t)
    assert sh.shard_shape(t.shape) == tuple(block.shape) == (4, 3)
    assert torch.equal(block, t[4:8, 0:3])


def test_single_process_mesh_is_none():
    assert tpar.make_mesh() is None
    assert tpar.make_mesh(devices=["cpu"]) is None
    with pytest.raises(ValueError, match="does not divide"):
        tpar.make_mesh(model=2)
    info = tpar.process_info()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_device_count": 1, "global_device_count": 1}
    assert tpar.local_shard_indices(10) == list(range(10))
    x = np.ones((4, 3))
    assert tpar.shard_batch(None, x) is x
    assert tpar.shard_padded_batch(None, x) == (x, 4)
    tree = {"a": torch.ones(2)}
    assert tpar.replicate(None, tree) is tree


# -- several processes -----------------------------------------------------


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_collectives(runs, world):
    ranks = runs[world]
    n = len(ranks)
    for r, res in enumerate(ranks):
        c = res["collectives"]
        want_sum = sum(np.arange(6, dtype=np.float32) + k for k in range(n))
        np.testing.assert_array_equal(c["sum"], want_sum)
        np.testing.assert_array_equal(
            c["gather"], np.stack([np.arange(6, dtype=np.float32) + k
                                   for k in range(n)]))
        np.testing.assert_array_equal(c["scatter"],
                                      np.full((2, 3), n * (n + 1) / 2))
        np.testing.assert_array_equal(c["bcast"], np.full(2, n - 1.0))
        assert c["info"]["process_index"] == r
        assert c["info"]["process_count"] == n
        per = (10 + n - 1) // n
        assert c["shard"] == list(range(r * per, min((r + 1) * per, 10)))


def _check_train(res, ref):
    losses, params = ref
    np.testing.assert_allclose(res["losses"], losses, rtol=RTOL_LOSS)
    assert res["params"].keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(res["params"][k], v, rtol=0, atol=ATOL_PARAM,
                                   err_msg=k)


@pytest.mark.parametrize("world,key,ref", [
    ("w2", "dp2", "full_ft"),
    ("w2", "tp2", "full_ft"),
    ("w2", "zero1_variant", "zero1_variant"),
    ("w2", "fsdp2", "full_ft"),
    ("w4", "dp2_tp2", "full_ft"),
    ("w4", "zero1_dp2_tp2", "full_ft"),
    ("w4", "fsdp_dp2_tp2", "full_ft"),
    ("w4", "multichip", "mc_single"),
])
def test_training_matches_jax(runs, world, key, ref):
    """Losses and the updated parameters of every rank against JAX's
    single-device steps on the global batch."""
    for res in runs[world]:
        _check_train(res[key], runs["ref"][ref])


def test_multichip_oracle(runs):
    """dp 2 x tp 2 against JAX's dp 4 x tp 2 mesh on ``dryrun_multichip``'s
    inputs: its recorded loss 10.8322."""
    ours = runs["w4"][0]["multichip"]["losses"][0]
    mesh_loss = runs["ref"]["mc_mesh"][0][0]
    assert ours == pytest.approx(mesh_loss, rel=RTOL_LOSS)
    assert round(ours, 4) == 10.8322


def test_local_shapes_are_shards(runs):
    """The moments and parameters each rank holds are its shards: ZeRO-1
    moments of a (64, 256) mlp1 at dp 2 x tp 2 are (32, 128); FSDP's
    parameter too; DP keeps them whole."""
    name = "decoder.blocks.0.mlp1.w"
    w4 = runs["w4"][0]
    assert w4["zero1_dp2_tp2"]["mu_shapes"][name] == (32, 128)
    assert w4["zero1_dp2_tp2"]["param_shapes"][name] == (64, 128)
    assert w4["fsdp_dp2_tp2"]["param_shapes"][name] == (32, 128)
    assert w4["dp2_tp2"]["mu_shapes"][name] == (64, 128)
    assert runs["w2"][0]["dp2"]["mu_shapes"][name] == (64, 256)
    assert runs["w2"][0]["fsdp2"]["param_shapes"][name] == (64, 128)


@pytest.mark.parametrize("name", list(DECODE))
def test_tp_decode_tokens_match_jax(runs, name):
    for res in runs["w2"]:
        assert res["decode_tp2"][name] == runs["ref"]["decode"][name]
    # each rank decoded on its half of the heads' columns
    assert runs["w2"][1]["decode_tp2"]["q_shape"] == (64, 32)
