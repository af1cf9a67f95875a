"""The port's dgc / terngrad / qsgd kernels' plain versions, the quantile
threshold, the packed wire words, the segment codecs and the three
``Compressor`` methods against the JAX package's.

On the CPU every ``repro_torch`` entry takes its plain PyTorch version; it
is held against the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and the JAX refs on the same numpy
inputs.  The random draws ``u`` are the reference's: JAX splits a PRNG
key per leaf and per hop, which a ``torch.Generator`` cannot reproduce,
so the port takes them as an input.  Integer planes, packed words, kept
sets, sparse counts and wire bytes must be equal exactly; fp32 outputs
within rtol 1e-6 (a reduction such as a norm, a standard deviation or a
bin mean is summed in another order), relative to the largest magnitude
where a difference can cancel.  The quantile threshold must equal
``jnp.quantile`` bit for bit, also past 2^24 elements.  The CUDA kernels
themselves are held against the plain versions in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as JCD
from repro.core import compression as JC
from repro.kernels import onebit as JK1
from repro.kernels import qsgd as JKQ
from repro.kernels import terngrad as JKT
from repro.kernels import topk as JKK
from repro.kernels.qsgd.qsgd import qsgd_compress as jax_qsgd
from repro.kernels.terngrad.terngrad import terngrad_compress as jax_tern
from repro.kernels.terngrad.ref import ternarize_ref as jax_ternarize_ref
from repro.kernels.terngrad.terngrad import terngrad_ternarize as jax_ternz
from repro.kernels.topk.topk import topk_compress as jax_topk
from repro_torch.comm import codecs as TCD
from repro_torch.core import compression as TC
from repro_torch.kernels import onebit as K1
from repro_torch.kernels import qsgd as KQ
from repro_torch.kernels import terngrad as KT
from repro_torch.kernels import topk as KK
from repro_torch.kernels.qsgd.ref import qsgd_decompress_ref

torch.set_num_threads(2)

RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, scale=None):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) if scale is None else scale
    err = np.abs(np.asarray(port, np.float64) - ref)
    assert err.max() <= RTOL * max(scale, 1e-30), err.max() / scale


def _equal(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _inputs(seed, R, C):
    rng = np.random.RandomState(seed)
    g = rng.standard_normal((R, C)).astype(np.float32)
    g[0, :7] = 0.0                        # exact zeros: sign(0) = 0
    g[1, 3] = 40.0                        # an outlier the clip cuts
    e = (0.3 * rng.standard_normal((R, C))).astype(np.float32)
    u = rng.random_sample((R, C)).astype(np.float32)
    return g, e, u


# ------------------------------------------------- plain kernel versions
@pytest.mark.parametrize("C", [256, 200])
def test_topk_matches_jax(C):
    g, e, _ = _inputs(C, 24, C)
    th = float(np.quantile(np.abs(g + e), 0.9))
    port = KK.sparsify(_t(g), _t(e), th)
    for ref in (jax_topk(jnp.asarray(g), jnp.asarray(e), th, interpret=True),
                JKK.topk_ref(jnp.asarray(g), jnp.asarray(e), th)):
        for a, b in zip(port, ref):
            _equal(a, b)
    # one threshold per segment of 8 rows: each segment as JAX does it
    ths = np.array([0.5, 1.0, 2.0], np.float32)
    kept, new_e = KK.sparsify(_t(g), _t(e), _t(ths))
    for s in range(3):
        rows = slice(8 * s, 8 * s + 8)
        ref = jax_topk(jnp.asarray(g[rows]), jnp.asarray(e[rows]),
                       float(ths[s]), interpret=True)
        _equal(kept[rows], ref[0])
        _equal(new_e[rows], ref[1])


@pytest.mark.parametrize("C", [256, 200])
def test_terngrad_matches_jax(C):
    g, _, u = _inputs(C + 1, 24, C)
    tern, s = KT.terngrad_ref(_t(g), _t(u), 2.5)
    for rt, rs in (jax_tern(jnp.asarray(g), jnp.asarray(u), clip_sigma=2.5,
                            interpret=True),
                   JKT.terngrad_ref(jnp.asarray(g), jnp.asarray(u), 2.5)):
        assert tern.dtype == torch.int8
        _equal(tern, rt)
        _close(s, rs)
    _close(KT.decompress(tern, s),
           JKT.decompress(jnp.asarray(tern.numpy()), rs))
    # the codec's entry: pre-clipped rows against an external scale, one
    # scale per segment
    gc = np.clip(g, -2.0, 2.0)
    scales = np.array([2.0, 1.5, 3.0], np.float32)
    port = KT.ternarize(_t(gc), _t(u), _t(scales))
    for s in range(3):
        rows = slice(8 * s, 8 * s + 8)
        for ref in (jax_ternz(jnp.asarray(gc[rows]), jnp.asarray(u[rows]),
                              scales[s], interpret=True),
                    jax_ternarize_ref(jnp.asarray(gc[rows]),
                                      jnp.asarray(u[rows]), scales[s])):
            _equal(port[rows], ref)


@pytest.mark.parametrize("regime", ["outlier", "uniform", "constant"])
def test_terngrad_compress_provisional_scale(regime):
    """The identity the card's terngrad_compress rests on: it ternarizes
    clip(g, +-sigma) against the provisional scale s = sigma, and only
    where the scale is not sigma (no element reaches the clip, or sigma is
    0) once more against s = max|g|.  JAX's terngrad_compress (interpret
    mode) must equal the port's ternarize_ref of that clip against that
    scale, bit for bit: a Gaussian with an outlier (max|g| >= sigma),
    uniform +-1 (2.5 sigma ~ 1.44 > max|g|) and a constant (std exactly 0:
    no clip, JAX's kernel takes s = max|g|)."""
    rng = np.random.RandomState(7)
    R, C = 24, 256
    if regime == "outlier":
        g = rng.standard_normal((R, C)).astype(np.float32)
        g[0, :7] = 0.0
        g[1, 3] = 40.0
    elif regime == "uniform":
        g = rng.uniform(-1.0, 1.0, (R, C)).astype(np.float32)
    else:
        g = np.full((R, C), 0.5, np.float32)
    u = rng.random_sample((R, C)).astype(np.float32)
    tern, scale = jax_tern(jnp.asarray(g), jnp.asarray(u), clip_sigma=2.5,
                           interpret=True)
    sigma = np.float32(jnp.std(jnp.asarray(g)) * 2.5)   # the kernel's sigma
    amax = np.abs(g).max()
    provisional = bool(sigma > 0 and amax >= sigma)
    assert provisional == (regime == "outlier")
    s = sigma if provisional else amax
    assert np.float32(scale) == s
    gc = np.clip(g, -sigma, sigma) if sigma > 0 else g
    _equal(KT.ternarize_ref(_t(gc), _t(u), _t(s)), tern)


@pytest.mark.parametrize("C", [256, 200])
def test_qsgd_matches_jax(C):
    g, _, u = _inputs(C + 2, 24, C)
    q, norm = KQ.quantize(_t(g), _t(u))
    for rq, rn in (jax_qsgd(jnp.asarray(g), jnp.asarray(u), interpret=True),
                   JKQ.qsgd_ref(jnp.asarray(g), jnp.asarray(u))):
        assert q.dtype == torch.int8
        _equal(q, rq)
        _close(norm, rn)
    _close(KQ.decompress(q, norm), JKQ.decompress(jnp.asarray(q.numpy()),
                                                  jnp.asarray(norm.numpy())))
    # one norm per segment of 8 rows, each as JAX computes its own
    qs, norms = KQ.quantize(_t(g), _t(u), segments=3)
    assert norms.shape == (3,)
    for s in range(3):
        rows = slice(8 * s, 8 * s + 8)
        rq, rn = jax_qsgd(jnp.asarray(g[rows]), jnp.asarray(u[rows]),
                          interpret=True)
        _equal(qs[rows], rq)
        _close(norms[s], rn)
        _close(qsgd_decompress_ref(qs, norms)[rows],
               JKQ.decompress(rq, rn))


def test_kernel_backend_needs_cuda():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        KK.sparsify(x, None, 0.5, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        KT.ternarize(x, x, 1.0, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        KQ.quantize(x, x, backend="kernel")


# --------------------------------------------------------------- quantile
@pytest.mark.parametrize("n", [1, 2, 1000, 4097])
@pytest.mark.parametrize("density", [0.01, 0.05, 0.3, 0.999])
def test_threshold_matches_jnp_quantile(n, density):
    rng = np.random.RandomState(n)
    g = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n).astype(np.float32)
    ref = JKK.threshold_for_density(jnp.asarray(g), jnp.asarray(e), density)
    port = KK.threshold_for_density(_t(g), _t(e), density)
    assert port.dtype == torch.float32 and port.shape == ()
    _equal(port.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("n", [2 ** 24 - 1, 2 ** 24 + 7])
def test_threshold_past_2_24_elements(n):
    """float32 positions: past 2^24, ``n - 1`` itself rounds to another
    float32, and the element jax interpolates from follows that."""
    g = np.random.RandomState(1).standard_normal(n).astype(np.float32)
    ref = jnp.quantile(jnp.abs(jnp.asarray(g)), 1.0 - 0.01)
    port = KK.threshold_for_density(_t(g), None, 0.01)
    _equal(port.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


def test_fma_f32_rounds_once():
    """The fused multiply-add the quantile's interpolation needs, against
    exact rational arithmetic, on cases built to sit at fp32 midpoints."""
    from fractions import Fraction
    from repro_torch.kernels.topk.ref import fma_f32
    rng = np.random.RandomState(0)
    a = rng.standard_normal(4000).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    b = np.float32(2.0 ** -30)
    c[:2000] = a[:2000] * np.float32(1 + 2.0 ** -23)     # near midpoints
    got = fma_f32(_t(a), float(b), _t(c)).numpy()
    for x, y, z in zip(a, c, got):
        exact = Fraction(float(x)) * Fraction(float(b)) + Fraction(float(y))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32))
                                         & 1))
        assert z == best, (x, y, z, best)


def test_threshold_per_segment():
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((3, 700)) * [[1.0], [10.0], [0.1]]).astype(
        np.float32)
    port = KK.threshold_for_density(_t(x), None, 0.05, segments=3)
    for s in range(3):
        ref = JKK.threshold_for_density(jnp.asarray(x[s]),
                                        jnp.zeros(700), 0.05)
        _equal(port[s].numpy().view(np.uint32),
               np.asarray(ref).view(np.uint32))


def test_threshold_nan_row():
    x = torch.tensor([[1.0, float("nan"), 3.0], [1.0, 2.0, 3.0]])
    th = KK.threshold_for_density(x, None, 0.5, segments=2)
    assert torch.isnan(th[0]) and th[1].item() == 2.0


# ------------------------------------------------------------ wire words
@pytest.mark.parametrize("R", [1, 5])
def test_pack_unpack_bits_match_jax(R):
    rng = np.random.RandomState(R)
    signs = np.where(rng.random_sample((R, 256)) > 0.5, 1, -1).astype(np.int8)
    signs[0, 31] = signs[0, 63] = 1               # the top bit of a word
    words = K1.pack_bits(_t(signs))
    ref = np.asarray(JK1.pack_bits(jnp.asarray(signs)))
    assert words.dtype == torch.int32 and words.shape == (R, 8)
    _equal(words.numpy().view(np.uint32), ref)
    _equal(K1.unpack_bits(words), signs)
    _equal(K1.unpack_bits(words, 200),
           np.asarray(JK1.unpack_bits(jnp.asarray(ref), 200)))


# ----------------------------------------------------------------- codecs
N, L_SEG = 3, 700            # workers, an odd segment (a padded last row)


def _segments(seed, L=L_SEG):
    """Per-worker segments of very different scales: a statistic taken
    over the whole worker axis instead of per worker would show."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((N, L)) * np.array([[1.0], [30.0], [0.01]])
    x[0, 5] = 0.0
    return x.astype(np.float32)


def _jax_codec(method):
    kw = {"density": 0.1} if method == "dgc" else {}
    return JCD.make_codec(method, **kw)


def _port_codec(method):
    kw = {"density": 0.1} if method == "dgc" else {}
    return TCD.make_codec(method, **kw)


def _jax_encode(method, x):
    """JAX's planes, decode and encode_ef residual per worker, and the
    uniform draws its stochastic codecs made ([N, rows, LANE])."""
    codec = _jax_codec(method)
    keys = [jax.random.PRNGKey(10 + w) for w in range(N)]
    rows = -(-x.shape[1] // JCD.LANE)
    u = np.stack([np.asarray(jax.random.uniform(k, (rows, JCD.LANE)))
                  for k in keys])
    out = []
    for w in range(N):
        seg = jnp.asarray(x[w])
        planes = codec.encode(seg, keys[w])
        _, res = codec.encode_ef(seg, keys[w])
        out.append((planes, np.asarray(codec.decode(planes)),
                    np.asarray(res)))
    return out, u


@pytest.mark.parametrize("method", ["none", "onebit", "terngrad", "qsgd",
                                    "dgc"])
def test_codec_matches_jax(method):
    x = _segments(len(method))
    ref, u = _jax_encode(method, x)
    codec = _port_codec(method)
    seg = _t(x)
    planes = codec.encode(seg, u=_t(u))
    dec = codec.decode(planes)
    _, res = codec.encode_ef(seg, u=_t(u))
    assert dec.shape == (N, ref[0][1].shape[0]) and res.shape == (N, L_SEG)
    for w, (rplanes, rdec, rres) in enumerate(ref):
        scale = float(np.abs(x[w]).max())
        for key, rp in rplanes.items():
            p = planes[key][w]
            rp = np.asarray(rp)
            if rp.dtype == np.uint32:                 # packed words
                _equal(p.numpy().view(np.uint32).reshape(rp.shape), rp)
            elif rp.dtype in (np.int8, np.bool_):     # levels, masks
                _equal(p.reshape(rp.shape), rp)
            elif key == "x" or key == "kept":         # values as sent
                _equal(p.reshape(rp.shape), rp)
            else:                                     # sp, sn, s, norm
                _close(p.reshape(rp.shape), rp)
        _close(dec[w], rdec, scale)
        _close(res[w], rres, scale)
    if method == "dgc":
        want = [int(JCD.DgcCodec(0.1).sent_elems(r[0])) for r in ref]
        assert codec.sent_elems(planes).tolist() == want
    for length in (1, 255, 256, 700, 65, 4096):
        assert codec.static_tx_bytes(length) == \
            _jax_codec(method).static_tx_bytes(length)


def test_dgc_codec_degenerate_threshold():
    """A mostly-zero segment: the threshold degenerates to 0, and only the
    nonzero elements count as sent, as in JAX."""
    x = np.zeros((N, 500), np.float32)
    x[:, :3] = [[1.0, -2.0, 3.0]]
    x[1, 100] = 0.5
    codec = _port_codec("dgc")
    planes = codec.encode(_t(x))
    want = [int(JCD.DgcCodec(0.1).sent_elems(
        JCD.DgcCodec(0.1).encode(jnp.asarray(x[w])))) for w in range(N)]
    assert codec.sent_elems(planes).tolist() == want == [3, 4, 3]
    np.testing.assert_allclose(codec.decode(planes)[:, :500].numpy(), x,
                               rtol=1e-6)


def test_codec_for_compressor():
    comp = TC.Compressor("qsgd", s_levels=15)
    assert isinstance(TCD.codec_for(comp), TCD.QsgdCodec)
    assert TCD.codec_for(comp).s_levels == 15
    assert TCD.codec_for(TC.Compressor("terngrad", clip_sigma=0.0)
                         ).clip_sigma == 0.0
    assert TCD.codec_for(TC.Compressor("dgc", density=0.2)).density == 0.2
    assert TCD.codec_for(TC.Compressor("none")).exact
    with pytest.raises(ValueError):
        TCD.make_codec("bogus")


# ------------------------------------------------------------ Compressor
SHAPES = [(512, 128), (128,), (2, 128, 128), (3, 40), (7,), (2, 64, 65)]


@pytest.mark.parametrize("method", ["terngrad", "qsgd"])
def test_compressor_stochastic_matches_jax(method):
    """Leaf by leaf with the reference's per-leaf draws, wire exact."""
    rng = np.random.RandomState(5)
    grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    key = jax.random.PRNGKey(7)
    jc, tc = JC.Compressor(method), TC.Compressor(method)
    jout, jstate, jwire = jc.roundtrip([jnp.asarray(g) for g in grads],
                                       None, key)
    assert tc.needs_rng and jstate is None
    keys = jax.random.split(key, len(grads))
    for g, k, ref in zip(grads, keys, jout):
        rows = -(-g.size // 256)
        u = np.asarray(jax.random.uniform(k, (rows, 256)))
        out, e = tc._leaf(_t(g), None, u=_t(u))
        assert e is None and tuple(out.shape) == g.shape
        _close(out, ref, float(np.abs(np.asarray(ref)).max()))
    gen = torch.Generator().manual_seed(0)
    _, state, wire = tc.roundtrip([_t(g) for g in grads], None, gen)
    assert state is None and wire == jwire
    assert sum(tc.wire_bytes(s) for s in SHAPES) == jwire


@pytest.mark.parametrize("min_channel", [64, 100])
def test_compressor_dgc_matches_jax(min_channel):
    """Two EF rounds: sparse values, the 1-bit remainder plane of
    channel-wise leaves, the flat leaves, and the wire bytes."""
    rng = np.random.RandomState(min_channel)
    jc = JC.Compressor("dgc", density=0.05, min_channel=min_channel)
    tc = TC.Compressor("dgc", density=0.05, min_channel=min_channel)
    jstate = jc.init_state([jnp.zeros(s) for s in SHAPES])
    tstate = tc.init_state([torch.zeros(s) for s in SHAPES])
    for _ in range(2):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        jout, jstate, jwire = jc.roundtrip([jnp.asarray(g) for g in grads],
                                           jstate)
        tout, tstate, twire = tc.roundtrip(
            iter(_t(g) for g in grads), tstate)
        assert twire == jwire
        assert sum(tc.wire_bytes(s) for s in SHAPES) == jwire
        for g, a, b, ea, eb in zip(grads, tout, jout, tstate, jstate):
            scale = float(np.abs(g).max()) * 4
            assert tuple(a.shape) == g.shape and a.dtype == torch.float32
            _close(a, b, scale)
            _close(ea, eb, scale)


def test_compressor_accepts_every_method():
    for method in TC.METHODS:
        comp = TC.Compressor(method)
        assert comp.needs_rng == (method in ("terngrad", "qsgd"))
    with pytest.raises(ValueError):
        TC.Compressor("bogus")
