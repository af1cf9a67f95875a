"""The port's 1-bit encode + EF path against the JAX package's.

On the CPU, ``repro_torch``'s ``encode_ef`` runs its plain PyTorch version;
it is held against the Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the JAX oracle on the same numpy
inputs, and so is ``compress`` against ``onebit_compress``: the int8 signs exactly, the fp32 outputs within rtol 1e-6 (a row
sum may be taken in another order; the bound is relative to the row's
largest |c_in|, since new_e is a difference that can cancel).  The
``Compressor`` is held against the JAX ``Compressor`` leaf by leaf over
two EF rounds, with the wire bytes exact.  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels import onebit as JK1
from repro.kernels.onebit.fused import onebit_encode_ef as jax_fused
from repro_torch.core import compression as TC
from repro_torch.kernels import onebit as K1

torch.set_num_threads(2)

RTOL = 1e-6


def _close(port, ref, scale):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    err = np.abs(port.astype(np.float64) - np.asarray(ref, np.float64))
    assert err.max() <= RTOL * scale, err.max() / scale


def _case(seed, R, C, has_e, has_valid):
    rng = np.random.RandomState(seed)
    g = rng.standard_normal((R, C)).astype(np.float32)
    e = (0.3 * rng.standard_normal((R, C))).astype(np.float32) if has_e \
        else None
    valid = (rng.random_sample((R, C)) > 0.3) if has_valid else None
    if valid is not None:
        valid[0] = False                 # a row with no valid element
    return g, e, valid


@pytest.mark.parametrize("C", [128, 256, 200])
@pytest.mark.parametrize("has_e,has_valid,symmetric",
                         list(itertools.product([False, True], repeat=3)))
def test_encode_ef_matches_jax(C, has_e, has_valid, symmetric):
    g, e, valid = _case(C + 4 * has_e + 2 * has_valid + symmetric, 24, C,
                        has_e, has_valid)
    gain = 2.0
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    port = K1.encode_ef(t(g), t(e), t(valid), gain=gain, symmetric=symmetric)
    pallas = jax_fused(j(g), j(e), j(valid), gain=gain, symmetric=symmetric,
                       interpret=True)
    oracle = JK1.onebit_encode_ef_ref(j(g), j(e), j(valid), gain=gain,
                                      symmetric=symmetric)
    cin = g if e is None else g + np.float32(gain) * e
    scale = float(np.abs(cin).max())
    assert port[0].dtype == torch.int8 and port[1].shape == (24, 1)
    for ref in (pallas, oracle):
        np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
        for a, b in zip(port[1:], ref[1:]):
            _close(a, b, scale)


def test_encode_ef_sign_of_zero_and_empty_bins():
    """c_in == 0 is +1; a row with no negatives (or no valid element)
    decodes its empty bin to 0 through the clamped count."""
    g = torch.tensor([[0.0, 1.0, 2.0, 3.0], [-1.0, 0.0, -3.0, 4.0]])
    signs, sp, sn, out, new_e = K1.encode_ef(g)
    assert signs.tolist() == [[1, 1, 1, 1], [-1, 1, -1, 1]]
    assert sn[0].item() == 0.0 and sp[0].item() == 1.5
    assert torch.equal(new_e, g - out)
    valid = torch.zeros_like(g, dtype=torch.bool)
    _, sp, sn, out, new_e = K1.encode_ef(g, valid=valid)
    assert sp.abs().sum() == 0 and out.abs().sum() == 0
    assert torch.equal(new_e, g)             # masked: new_e = c_true


def test_encode_ef_kernel_backend_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        K1.encode_ef(torch.zeros(2, 4), backend="kernel")


# ------------------------------------------------------- onebit_compress
@pytest.mark.parametrize("R,C", [(8, 128), (64, 256), (100, 512), (3, 1024),
                                 (33, 200)])
def test_compress_matches_jax(R, C):
    """``compress`` (plain version on the CPU) against the Pallas kernel in
    interpret mode and the JAX oracle, on the shapes of
    tests/test_kernels.py: signs exactly, scale and new_e within rtol 1e-6
    of the row's largest |c|."""
    rng = np.random.RandomState(R * C)
    g = rng.standard_normal((R, C)).astype(np.float32)
    e = (0.3 * rng.standard_normal((R, C))).astype(np.float32)
    e[0, : C // 2] = -g[0, : C // 2]             # c exactly 0: sign +1
    port = K1.compress(torch.from_numpy(g), torch.from_numpy(e))
    scale = float(np.abs(g + e).max())
    assert port[0].dtype == torch.int8 and port[1].shape == (R, 1)
    assert (port[0][0, : C // 2] == 1).all()
    for ref in (JK1.compress(jnp.asarray(g), jnp.asarray(e)),
                JK1.onebit_ref(jnp.asarray(g), jnp.asarray(e))):
        np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
        for a, b in zip(port[1:], ref[1:]):
            _close(a, b, scale)
    np.testing.assert_array_equal(
        K1.decompress(port[0], port[1]).numpy(),
        np.asarray(JK1.decompress(jnp.asarray(port[0].numpy()),
                                  jnp.asarray(port[1].numpy()))))


def test_compress_kernel_backend_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        K1.compress(torch.zeros(2, 4), torch.zeros(2, 4), backend="kernel")
    with pytest.raises(ValueError, match="want g, e"):
        K1.compress(torch.zeros(2, 4), torch.zeros(2, 5))


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 65536])
def test_wire_bytes_matches_jax(n):
    assert K1.wire_bytes(n) == JK1.wire_bytes(n)


# ----------------------------------------------------------- Compressor
SHAPES = [(512, 128), (128,), (2, 128, 128), (2, 256, 128), (2, 128, 256),
          (3, 40), (7,), (2, 64, 65)]


@pytest.mark.parametrize("min_channel", [64, 100])
def test_compressor_roundtrip_matches_jax(min_channel):
    """Two EF rounds over leaves of the reduced model's shapes (plus a
    narrow and a ragged one): channel-wise and flat layouts, leaf by
    leaf."""
    rng = np.random.RandomState(min_channel)
    jc = JC.Compressor("onebit", min_channel=min_channel)
    tc = TC.Compressor("onebit", min_channel=min_channel)
    jstate = jc.init_state([jnp.zeros(s) for s in SHAPES])
    tstate = tc.init_state([torch.zeros(s) for s in SHAPES])
    for _ in range(2):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        jout, jstate, jwire = jc.roundtrip([jnp.asarray(g) for g in grads],
                                           jstate)
        tout, tstate, twire = tc.roundtrip(
            iter(torch.from_numpy(g) for g in grads), tstate)
        assert twire == jwire
        for g, a, b, ea, eb in zip(grads, tout, jout, tstate, jstate):
            scale = float(np.abs(g).max()) * 4
            assert tuple(a.shape) == g.shape and a.dtype == torch.float32
            _close(a, b, scale)
            _close(ea, eb, scale)


def test_onebit_plane_matches_jax():
    g, _, valid = _case(7, 16, 200, False, True)
    jout, jwb = JC.Compressor("onebit")._onebit_plane(jnp.asarray(g),
                                                      jnp.asarray(valid))
    tout, twb = TC.Compressor("onebit")._onebit_plane(
        torch.from_numpy(g), torch.from_numpy(valid))
    assert twb == jwb
    _close(tout, jout, float(np.abs(g).max()))


def test_compressor_none_and_wire_bytes_match_jax():
    grads = [np.ones(s, np.float32) for s in SHAPES]
    jout, _, jwire = JC.Compressor("none").roundtrip(
        [jnp.asarray(g) for g in grads], None)
    tout, state, twire = TC.Compressor("none").roundtrip(
        [torch.from_numpy(g) for g in grads], None)
    assert twire == jwire and state is None
    assert all(torch.equal(a, torch.from_numpy(g))
               for a, g in zip(tout, grads))
    for method in ("none", "onebit"):
        comp = TC.Compressor(method)
        _, _, wire = JC.Compressor(method).roundtrip(
            [jnp.zeros(s) for s in SHAPES],
            JC.Compressor(method).init_state([jnp.zeros(s) for s in SHAPES]))
        assert sum(comp.wire_bytes(s) for s in SHAPES) == wire


@pytest.mark.parametrize("method", ["dgc", "terngrad", "qsgd"])
def test_unported_methods_raise(method):
    """The three methods are ported (tests/test_torch_codecs.py), and so
    is their parameter-server exchange (tests/test_torch_comm.py holds it
    against JAX): nothing raises any more.  Here: the PS push of one 300-element leaf over 2 workers,
    (n - 1) encoded half-leaves plus (n - 1) fp32 half-leaves of bytes."""
    from repro_torch.comm.plan import CommPlan
    assert method in TC.METHODS
    comp = TC.Compressor(method)
    plan = CommPlan.plan([(300,)], n=2, compressor=comp, wire="measured")
    assert plan.in_schedule
    grads = [[torch.randn(300)], [torch.randn(300)]]
    ef = ([[torch.zeros(300)], [torch.zeros(300)]]
          if method in TC.EF_METHODS else None)
    new, _, sent = plan.ps_exchange([torch.zeros(300)], grads, ef,
                                    torch.Generator().manual_seed(0), 1.0)
    assert new[0].shape == (300,) and torch.isfinite(new[0]).all()
    assert sent.shape == (2,)
    assert plan.measured_step_tx_bytes("ps") == \
        plan.codec.static_tx_bytes(150) + 4 * 150
