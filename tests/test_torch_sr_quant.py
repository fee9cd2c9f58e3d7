"""PyTorch port: K9's plain version (stochastic int8 quantization) and
``quantize_params_device`` against the JAX package, on the CPU.

The two packages draw their uniforms from different generators (Philox
here, four columns a block, ``jax.random`` in the JAX package's CPU
path), so codes are not
compared bit for bit; the contract is: each code the floor or the ceiling
of the quotient, the error below one step, and the quarter-step mean
unbiased within 0.02 (``tests/test_quant.py``). The scales are the IEEE
quotient max(amax, 1e-8) / 127, bit-identical to the host quantizer's (and
to the TPU kernel's division). XLA on the CPU rewrites that division by a
constant as a product with the f32 reciprocal, so the JAX package's CPU
scales are that product, at most one ulp away: the test states both. The
Philox generator itself is held to Random123's known answers. The
grouped launch's plan (``sr_quant_plan``) covers every element once, and
an emulation of the kernel's clusters walking it equals the per-weight
plain version. The CUDA kernel equals the plain version bit for bit on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import bisect
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.ops.sr_quant as jax_sr
import whisper_ipa_torch.ops.sr_quant as sr
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.models import flatten_params, params_from_numpy
from whisper_ipa_torch.ops.precision import div_ieee
from whisper_ipa_torch.ops.quant import quantize_params
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)


# Random123's known answers for Philox4x32-10: counter, key -> output
@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    c = [torch.tensor([x], dtype=torch.int64) for x in counter]
    got = sr.philox4x32_10(*c, *key)
    assert tuple(int(w) for w in got) == want


def _jax_cpu_scales(ours: np.ndarray, w: np.ndarray,
                    theirs: np.ndarray) -> None:
    """The JAX package's CPU scales are amax * f32(1/127), one ulp at most
    from the IEEE quotient that the port, the host quantizer and the
    kernels compute."""
    amax = np.maximum(np.abs(w).max(axis=0), np.float32(1e-8))
    np.testing.assert_array_equal(ours, amax / np.float32(127.0))
    np.testing.assert_array_equal(theirs, amax * np.float32(1.0 / 127.0))
    assert (np.abs(ours - theirs) <= np.spacing(ours)).all()


def _contract(w: np.ndarray, q: np.ndarray, s: np.ndarray) -> None:
    """Each code is floor or ceil of the IEEE quotient; error < one step."""
    quot = w / s  # float32 / float32: the IEEE quotient
    lo = np.clip(np.floor(quot), -127, 127)
    hi = np.clip(np.floor(quot) + 1, -127, 127)
    assert ((q == lo) | (q == hi)).all()
    deq = q.astype(np.float32) * s
    assert (np.abs(deq - w).max(axis=0) <= s + 1e-6).all()


@pytest.fixture(scope="module")
def weight():
    return np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32)


def test_plain_contract_against_jax(weight):
    q, s = sr.stochastic_quantize_int8(torch.from_numpy(weight), seed=3)
    assert q.dtype == torch.int8 and s.shape == (64,) and s.dtype == torch.float32
    jq, js = jax_sr.stochastic_quantize_int8(jnp.asarray(weight), seed=3)
    _jax_cpu_scales(s.numpy(), weight, np.asarray(js))
    _contract(weight, q.numpy(), s.numpy())
    _contract(weight, np.asarray(jq), np.asarray(js))
    # the same stochastic rounding: codes differ only where the draws do,
    # and then by one step
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1


def test_plain_scales_equal_host_quantizer(weight):
    from whisper_ipa_torch.ops.quant import quantize_linear

    _, s = sr.stochastic_quantize_int8(torch.from_numpy(weight), seed=1)
    host = quantize_linear({"w": torch.from_numpy(weight)})
    torch.testing.assert_close(s, host["w_s"], rtol=0, atol=0)
    # round-to-nearest and stochastic codes are at most one step apart
    q, _ = sr.stochastic_quantize_int8(torch.from_numpy(weight), seed=1)
    assert (q.int() - host["w_q"].int()).abs().max() <= 1


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_quarter_step_unbiased(package):
    w = np.full((4096, 8), 0.25, np.float32)
    w[0] = 127.0  # scale 1.0
    if package == "torch":
        q, s = (t.numpy() for t in sr.stochastic_quantize_int8(
            torch.from_numpy(w), seed=11))
    else:
        q, s = (np.asarray(t) for t in jax_sr.stochastic_quantize_int8(
            jnp.asarray(w), seed=11))
    assert (s == 1.0).all()
    deq = q[1:].astype(np.float32) * s
    assert abs(deq.mean() - 0.25) < 0.02


def test_seeds(weight):
    w = torch.from_numpy(weight)
    a, _ = sr.stochastic_quantize_int8(w, seed=5)
    b, _ = sr.stochastic_quantize_int8(w, seed=5)
    c, _ = sr.stochastic_quantize_int8(w, seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_uniform_bits_are_uniform():
    u = sr.uniform_bits(512, 256, seed=0)
    assert u.dtype == torch.float32 and u.shape == (512, 256)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    # one row or one column of counters does not repeat another
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[:, 0], u[:, 1])


def test_uniform_bits_philox_block_layout():
    """Columns 4j..4j+3 of row r are words 0..3 of the Philox block at
    counter (j, r, 0, 0); the four columns of a block differ."""
    u = sr.uniform_bits(6, 12, seed=9)
    for r in range(6):
        for j in range(3):
            c = [torch.tensor([x], dtype=torch.int64) for x in (j, r, 0, 0)]
            words = sr.philox4x32_10(*c, 9, 0)
            want = [(int(wd) >> 9) | 0x3F800000 for wd in words]
            mant = (u[r, 4 * j:4 * j + 4] + 1.0).view(torch.int32).numpy()
            np.testing.assert_array_equal(mant, np.array(want, np.int32))
            assert len(set(mant.tolist())) == 4
    # the four words are uncorrelated columns of a uniform field
    big = sr.uniform_bits(2048, 64, seed=2)
    for k in range(4):
        col = big[:, k::4]
        assert float(col.min()) >= 0.0 and float(col.max()) < 1.0
        assert abs(float(col.mean()) - 0.5) < 0.01
    corr = np.corrcoef(big[:, 0::4].flatten().numpy(),
                       big[:, 1::4].flatten().numpy())[0, 1]
    assert abs(corr) < 0.02


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        sr.stochastic_quantize_int8(torch.zeros(4))
    with pytest.raises(ValueError):
        sr.stochastic_quantize_int8(torch.zeros((0, 3)))


def test_grouped_wrapper_rejects_bad_arguments():
    with pytest.raises(ValueError):
        sr.stochastic_quantize_int8_many([torch.zeros((2, 3))], [1, 2])
    with pytest.raises(ValueError):
        sr.stochastic_quantize_int8_many([torch.zeros((2, 3)), torch.zeros(3)],
                                         [1, 2])
    with pytest.raises(ValueError):
        sr.sr_quant_plan([(4, 0)])
    with pytest.raises(ValueError):  # more than the kernel's table holds
        sr.sr_quant_plan([(4, 4)] * (sr.MAX_ENTRIES + 1))
    assert sr.stochastic_quantize_int8_many([], []) == []


# weight lists of one launch: whisper-small's block shapes (narrowed),
# ragged rows and columns, a slice of under one row a block, and a slice
# above the shared-memory stage (read twice)
PLAN_SHAPES = {
    "mixed": [(64, 64), (256, 64), (64, 256), (300, 70), (5, 3), (33, 129)],
    "small-like": [(768, 768), (768, 3072), (3072, 768)],
    "tall": [(sr.MAX_STAGE // 4 + 9, 40), (16, 8)],
}


def plan_block(plan, block: int):
    """What block ``block`` of the launch owns, as csrc/sr_quant.cu finds
    it: (weight index, rows range, columns range, staged)."""
    tile, rank = divmod(block, sr.CLUSTER)
    k = bisect.bisect_right(plan.tile0, tile) - 1
    i = plan.order[k]
    (rows, cols), strip = plan.shapes[i], plan.strips[i]
    slice_ = -(-rows // sr.CLUSTER)
    col0 = (tile - plan.tile0[k]) * strip
    r0, r1 = min(rank * slice_, rows), min((rank + 1) * slice_, rows)
    return (i, range(r0, r1), range(col0, min(col0 + strip, cols)),
            slice_ * strip <= plan.stage)


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_sr_quant_plan_covers_every_element_once(name):
    shapes = PLAN_SHAPES[name]
    plan = sr.sr_quant_plan(shapes)
    assert all(w in sr.STRIPS for w in plan.strips)
    assert plan.tiles == sum(-(-c // w) for (_, c), w in zip(shapes, plan.strips))
    slices = [-(-r // sr.CLUSTER) for r, _ in shapes]
    work = [x * w for x, w in zip(slices, plan.strips)]
    # the longest tiles first, ties tallest first
    assert [(work[i], shapes[i][0]) for i in plan.order] == sorted(
        zip(work, (r for r, _ in shapes)), reverse=True)
    assert list(plan.tile0) == sorted(plan.tile0) and plan.tile0[0] == 0
    assert plan.stage == max((x for x in work if x <= plan.stage), default=0)
    assert plan.stage <= sr.MAX_STAGE and plan.stage % 4 == 0
    hits = [np.zeros(s, np.int32) for s in shapes]
    for block in range(plan.tiles * sr.CLUSTER):
        i, rows, cols, staged = plan_block(plan, block)
        strip = plan.strips[i]
        assert len(cols) and len(cols) <= strip and cols.start % strip == 0
        assert len(rows) <= slices[i] and staged == (work[i] <= plan.stage)
        if len(rows):
            hits[i][rows.start:rows.stop, cols.start:cols.stop] += 1
        # the cluster of this block quantizes one weight's strip
        assert plan_block(plan, block - block % sr.CLUSTER)[0] == i
    for h in hits:
        assert (h == 1).all()
    if name == "small-like":
        # a block of a short weight holds as many floats as a tall one's
        assert plan.strips == (128, 128, 32) and plan.stage == 384 * 32
        assert len(set(work)) == 1
    if name == "tall":
        assert not plan_block(plan, 0)[3]  # the stage cannot hold it


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (300, 70), (768, 3072),
                                   (3072, 768), (6144, 8), (6153, 40)])
def test_single_weight_launch_is_the_plan_of_one(shape):
    """csrc/sr_quant.cu's single-weight entry (wipa_sr_quant_int8) builds
    its table of one by this rule: strips of 32 columns, the slice in
    shared memory if it holds at most MAX_STAGE floats, else none (read
    twice). It is the plan of a list of one."""
    rows, cols = shape
    slice_ = -(-rows // sr.CLUSTER)
    plan = sr.sr_quant_plan([shape])
    assert plan.strips == (32,) and plan.order == (0,) and plan.tile0 == (0,)
    assert plan.tiles == -(-cols // 32)
    assert plan.stage == (slice_ * 32 if slice_ * 32 <= sr.MAX_STAGE else 0)


def test_grouped_outputs_are_disjoint_views():
    """The grouped call's codes and scales: one int8 and one f32 buffer,
    cut into contiguous views that do not overlap, each shape's region
    starting 16-byte aligned."""
    shapes = [(3, 6), (768, 64), (3, 6), (5, 3), (768, 64), (2, 8)]
    qs, ss = sr._outputs(shapes, torch.device("cpu"))
    for views, want in ((qs, shapes), (ss, [(c,) for _, c in shapes])):
        assert [tuple(v.shape) for v in views] == want
        assert all(v.is_contiguous() for v in views)
        spans = sorted((v.data_ptr(), v.data_ptr() + v.nbytes) for v in views)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert len({v.untyped_storage().data_ptr() for v in views}) == 1
    assert qs[0].dtype == torch.int8 and ss[0].dtype == torch.float32
    base = qs[0].untyped_storage().data_ptr()
    firsts = {shapes.index(s) for s in shapes}
    assert all((qs[i].data_ptr() - base) % 16 == 0 for i in firsts)


def _emulate_launch(weights, seeds):
    """The grouped kernel's arithmetic, walking its plan: each cluster's
    blocks reduce their slices' column maxima, the merged maxima give the
    strip's scales, and each block quantizes its own slice with the bits of
    its (row, col)."""
    plan = sr.sr_quant_plan([tuple(w.shape) for w in weights])
    # u is a function of (seed, row, col): a block draws its window
    field = [sr.uniform_bits(*w.shape, seed) for w, seed in zip(weights, seeds)]
    qs = [torch.full(tuple(w.shape), 99, dtype=torch.int8) for w in weights]
    ss = [torch.full((w.shape[1],), -1.0) for w in weights]
    for tile in range(plan.tiles):
        blocks = [plan_block(plan, tile * sr.CLUSTER + r)
                  for r in range(sr.CLUSTER)]
        i, _, cols, _ = blocks[0]
        w = weights[i]
        part = torch.stack([
            w[rows.start:rows.stop, cols.start:cols.stop].abs().amax(dim=0)
            if len(rows) else torch.zeros(len(cols))
            for _, rows, _, _ in blocks])
        s = div_ieee(torch.clamp_min(part.amax(dim=0), 1e-8), 127.0)
        ss[i][cols.start:cols.stop] = s
        for _, rows, _, _ in blocks:
            if not len(rows):
                continue
            x = w[rows.start:rows.stop, cols.start:cols.stop]
            u = field[i][rows.start:rows.stop, cols.start:cols.stop]
            qs[i][rows.start:rows.stop, cols.start:cols.stop] = torch.clamp(
                torch.floor(x / s + u), -127, 127).to(torch.int8)
    return list(zip(qs, ss))


@pytest.mark.parametrize("name", ["mixed", "tall"])
@pytest.mark.parametrize("seed", [0, 2 ** 32 + 5])
def test_grouped_emulation_equals_plain(name, seed):
    rng = np.random.default_rng(seed % 97)
    weights = [torch.from_numpy((0.05 * rng.standard_normal(s))
                                .astype(np.float32))
               for s in PLAN_SHAPES[name]]
    weights[0][:, 1] = 0.0  # an all-zero column: scale 1e-8 / 127, codes 0
    seeds = [seed + 3 * k for k in range(len(weights))]
    got = _emulate_launch(weights, seeds)
    grouped = sr.stochastic_quantize_int8_many(weights, seeds)
    for w, sd, (q, s), (gq, gs) in zip(weights, seeds, got, grouped):
        pq, ps = sr.stochastic_quantize_int8_plain(w, sd)
        assert torch.equal(q, pq) and torch.equal(s, ps)
        assert torch.equal(gq, pq) and torch.equal(gs, ps)
    assert (got[0][0][:, 1] == 0).all()


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


def _recorded(monkeypatch, module, params, to_numpy):
    """quantize_params_device of ``module`` with each weight's seed
    recorded against the weight's values."""
    seen = []
    orig = module.stochastic_quantize_int8

    def record(w, seed=0):
        seen.append((seed, to_numpy(w)))
        return orig(w, seed=seed)

    monkeypatch.setattr(module, "stochastic_quantize_int8", record)
    out = module.quantize_params_device(params, seed=7)
    monkeypatch.undo()
    return out, seen


def _visit(tree):
    """The block-weight dicts of a tree in the reference's visit order:
    the decoder's blocks, then the encoder's."""
    def walk(t):
        if isinstance(t, dict):
            w = t.get("w")
            if "w_q" in t or (isinstance(w, torch.Tensor) and w.dim() == 2):
                yield t
            else:
                for v in t.values():
                    yield from walk(v)
        elif isinstance(t, list):
            for v in t:
                yield from walk(v)

    for side in ("decoder", "encoder"):
        yield from walk(tree[side]["blocks"])


def test_quantize_params_device_matches_jax(monkeypatch, params, jax_params):
    calls = []
    grouped = sr.stochastic_quantize_int8_many

    def record(ws, seeds):
        calls.append((list(seeds), [w.numpy() for w in ws]))
        return grouped(ws, seeds)

    monkeypatch.setattr(sr, "stochastic_quantize_int8_many", record)
    qp = sr.quantize_params_device(params, seed=7)
    monkeypatch.undo()
    jqp, jseen = _recorded(monkeypatch, jax_sr, jax_params, np.asarray)

    # one grouped call for the tree; every weight gets the same seed
    # integer in both packages, in the reference's visit order
    assert len(calls) == 1
    seeds, seen = calls[0]
    assert seeds == [s for s, _ in jseen] == list(range(8, 8 + len(seen)))
    for a, (_, b) in zip(seen, jseen):
        np.testing.assert_array_equal(a, b)
    assert len(seen) == 6 * (JCFG.n_audio_layer + JCFG.n_text_layer) + (
        4 * JCFG.n_text_layer)
    # each tree weight's codes and scales are stochastic_quantize_int8's
    # with its seed
    pairs = list(zip(_visit(params), _visit(qp)))
    assert len(pairs) == len(seen)
    for i, (p, q) in enumerate(pairs):
        np.testing.assert_array_equal(p["w"].numpy(), seen[i])
        want_q, want_s = sr.stochastic_quantize_int8(p["w"], seed=8 + i)
        assert torch.equal(q["w_q"], want_q) and torch.equal(q["w_s"], want_s)

    flat = flatten_params(qp)
    jflat = {k: np.asarray(v) for k, v in jax_flatten_params(jqp).items()}
    host = flatten_params(quantize_params(params, bits=8))
    assert sorted(flat) == sorted(jflat) == sorted(host)
    for name, t in flat.items():
        assert tuple(t.shape) == jflat[name].shape == tuple(host[name].shape)
        assert str(t.dtype).split(".")[-1] == str(jflat[name].dtype), name
        if name.endswith(".w_s"):
            np.testing.assert_array_equal(t.numpy(), host[name].numpy())
            assert (np.abs(t.numpy() - jflat[name])
                    <= np.spacing(t.numpy())).all(), name
        elif name.endswith(".w_q"):
            assert (t.int() - host[name].int()).abs().max() <= 1
        else:  # biases, norms, embeddings, the conv stem: untouched
            np.testing.assert_array_equal(t.numpy(), jflat[name])


def test_quantize_params_device_frees_without_the_collector(params):
    """The quantized tree holds no reference cycle: its codes are freed
    when the tree is dropped, not when the cyclic collector next runs (on
    the card they are views of one buffer of every weight's codes)."""
    import gc
    import weakref

    enabled = gc.isenabled()
    gc.disable()
    try:
        qp = sr.quantize_params_device(params)
        ref = weakref.ref(qp["encoder"]["blocks"][0]["mlp1"]["w_q"])
        del qp
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_quantize_params_device_decodes(params):
    qp = sr.quantize_params_device(params)
    blk = qp["decoder"]["blocks"][0]["attn"]["query"]
    assert "w_q" in blk and "w_s" in blk and "w" not in blk
    mel = np.random.default_rng(0).standard_normal(
        (1, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(np.float32)
    results = decode(
        qp, CFG, mel,
        DecodingOptions(language="en", without_timestamps=True, sample_len=4),
        tokenizer=get_tokenizer(multilingual=True, language="en"),
    )
    assert np.isfinite(results[0].avg_logprob)
