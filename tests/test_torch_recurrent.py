"""The port's recurrent pieces on the CPU against the JAX package's:
``chunked_scan``, the Mamba block (``ssm.py``) and the mLSTM and sLSTM
blocks (``xlstm.py``), forward (with and without a carried state) and
decode step.

The JAX package's own parameters (``init_params(PRNGKey(0))`` of each
block's specs) are carried into the port through numpy, at the smoke
configs of jamba-v0.1-52b (Mamba) and xlstm-125m (mLSTM, sLSTM), in f32.

Tolerance: ``tests/test_kernels.py``'s f32 TOLS (2e-5) on outputs and
states.  Both packages run the same fp32 recurrences and differ only in
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import scan_utils as jax_scan_utils
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy, ssm, xlstm
from repro_torch.models.scan_utils import chunked_scan

TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 64


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want):
    """Every leaf of the port's tree against the JAX one."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k])
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def block(arch, specs_fn, seed=0):
    """(port cfg, JAX params, port params) of one block at smoke size."""
    jcfg = jax_get_config(arch).smoke()
    jp = jax_init_params(specs_fn(jcfg), jax.random.PRNGKey(seed))
    return get_config(arch).smoke(), jp, params_from_numpy(to_np(jp))


def inputs(d, n=S, seed=1):
    x = np.random.default_rng(seed).normal(size=(B, n, d)).astype(np.float32)
    return x, torch.from_numpy(x)


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------


def _decay_step(lib):
    """A carry of two leaves and an output of two, as the mixers' are."""
    def step(carry, xs):
        h, s = carry
        a, b = xs
        h = lib.tanh(0.9 * h + a * b)
        s = s + (h * b).sum(-1)
        return (h, s), (h * 2.0, s)
    return step


@pytest.mark.parametrize("L,chunk", [(37, 8), (64, 128), (5, 1)])
def test_chunked_scan_matches_jax(L, chunk):
    """Values and gradients, at a length that is not a chunk multiple: the
    padded steps run and update the carry, as the JAX package's do."""
    rng = np.random.default_rng(L)
    a, b = (rng.normal(size=(L, 3, 4)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(3, 4)).astype(np.float32)
    s0 = np.zeros(3, np.float32)

    def jax_loss(a, b, h0):
        (h, s), (y, z) = jax_scan_utils.chunked_scan(
            _decay_step(jnp), (h0, s0), (a, b), chunk_size=chunk)
        return (y ** 2).sum() + z.sum() + (h * s[:, None]).sum(), (h, s, y, z)

    (jl, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (a, b, h0)))
    ta, tb, th0 = (torch.from_numpy(t).requires_grad_(True) for t in (a, b, h0))
    (h, s), (y, z) = chunked_scan(_decay_step(torch), (th0, torch.from_numpy(s0)),
                                  (ta, tb), chunk_size=chunk)
    loss = (y ** 2).sum() + z.sum() + (h * s[:, None]).sum()
    loss.backward()
    for got, want in zip((h, s, y, z), jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert y.shape == (L, 3, 4)
    # gradients as test_torch_training.py holds them: within 1e-4 of each
    # tensor's largest magnitude (they span 1e-3 to 1e2 here)
    for got, want in zip((ta.grad, tb.grad, th0.grad), jgrads):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_chunked_scan_keeps_no_graph_without_grad():
    """With nothing to differentiate the chunks run as the plain loop, and
    with a gradient under checkpoint: both give the same values."""
    a = torch.randn(20, 3, 4)
    init = (torch.zeros(3, 4), torch.zeros(3))
    plain = chunked_scan(_decay_step(torch), init, (a, a), chunk_size=6)
    ar = a.clone().requires_grad_(True)
    remat = chunked_scan(_decay_step(torch), init, (ar, ar), chunk_size=6)
    assert plain[1][0].grad_fn is None and remat[1][0].grad_fn is not None
    for got, want in zip(jax.tree.leaves(remat), jax.tree.leaves(plain)):
        assert torch.equal(got.detach(), want)


def test_chunked_scan_needs_an_xs_leaf():
    with pytest.raises(ValueError, match="at least one xs leaf"):
        chunked_scan(lambda c, x: (c, x), torch.zeros(1), ())


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def test_causal_depthwise_conv_matches_jax():
    """The taps' orientation: w[k - 1] takes the current token."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    want = jax_ssm._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm.causal_depthwise_conv(*(torch.from_numpy(t) for t in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one tap: the output at t is w[k - 1 - i] * x[t - i]
    np.testing.assert_allclose(got[0, 5, 0].item(), sum(
        w[3 - i, 0] * x[0, 5 - i, 0] for i in range(4)) + b[0], rtol=1e-5)


def test_mamba_forward_matches_jax():
    cfg, jp, tp = block("jamba-v0.1-52b", jax_ssm.mamba_specs)
    x, xt = inputs(cfg.d_model)
    want, wstate = jax_ssm.mamba_forward(jp, jax_get_config("jamba-v0.1-52b").smoke(),
                                         jnp.asarray(x), chunk_size=16)
    got, state = ssm.mamba_forward(tp, cfg, xt, chunk_size=16)
    close(got, want)
    close(state, wstate)


@pytest.mark.parametrize("split", [40, 62])
def test_mamba_forward_with_a_carried_state_matches_jax(split):
    """The second part of a sequence from the first part's state, including
    a second part of 2 tokens, shorter than the conv window (a first part
    that short fails in both packages: the conv's shifts outgrow it)."""
    jcfg = jax_get_config("jamba-v0.1-52b").smoke()
    cfg, jp, tp = block("jamba-v0.1-52b", jax_ssm.mamba_specs)
    x, xt = inputs(cfg.d_model)
    _, jstate = jax_ssm.mamba_forward(jp, jcfg, jnp.asarray(x[:, :split]))
    want, wstate = jax_ssm.mamba_forward(jp, jcfg, jnp.asarray(x[:, split:]), state=jstate)
    _, state = ssm.mamba_forward(tp, cfg, xt[:, :split])
    got, state = ssm.mamba_forward(tp, cfg, xt[:, split:], state=state)
    close(got, want)
    close(state, wstate)


def test_mamba_decode_step_matches_jax():
    jcfg = jax_get_config("jamba-v0.1-52b").smoke()
    cfg, jp, tp = block("jamba-v0.1-52b", jax_ssm.mamba_specs)
    x, xt = inputs(cfg.d_model, n=12)
    jstate = jax_ssm.mamba_init_state(jcfg, B)
    state = ssm.mamba_init_state(cfg, B)
    close(state, jstate)
    for t in range(x.shape[1]):
        want, jstate = jax_ssm.mamba_decode_step(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                                 jstate)
        got, state = ssm.mamba_decode_step(tp, cfg, xt[:, t:t + 1], state)
        close(got, want)
        close(state, jstate)
    # token by token is the forward over the sequence
    full, _ = ssm.mamba_forward(tp, cfg, xt)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------

MIXERS = {
    "mlstm": (jax_xlstm.mlstm_specs, jax_xlstm.mlstm_forward, jax_xlstm.mlstm_decode_step,
              jax_xlstm.mlstm_init_state, xlstm.mlstm_forward, xlstm.mlstm_decode_step,
              xlstm.mlstm_init_state),
    "slstm": (jax_xlstm.slstm_specs, jax_xlstm.slstm_forward, jax_xlstm.slstm_decode_step,
              jax_xlstm.slstm_init_state, xlstm.slstm_forward, xlstm.slstm_decode_step,
              xlstm.slstm_init_state),
}


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_xlstm_forward_matches_jax(kind):
    specs, jfwd, _, _, tfwd, _, _ = MIXERS[kind]
    jcfg = jax_get_config("xlstm-125m").smoke()
    cfg, jp, tp = block("xlstm-125m", specs)
    x, xt = inputs(cfg.d_model)
    want, wstate = jfwd(jp, jcfg, jnp.asarray(x), chunk_size=16)
    got, state = tfwd(tp, cfg, xt, chunk_size=16)
    close(got, want)
    close(state, wstate)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_xlstm_forward_with_a_carried_state_matches_jax(kind):
    specs, jfwd, _, _, tfwd, _, _ = MIXERS[kind]
    jcfg = jax_get_config("xlstm-125m").smoke()
    cfg, jp, tp = block("xlstm-125m", specs)
    x, xt = inputs(cfg.d_model)
    _, jstate = jfwd(jp, jcfg, jnp.asarray(x[:, :62]))
    want, wstate = jfwd(jp, jcfg, jnp.asarray(x[:, 62:]), state=jstate)
    _, state = tfwd(tp, cfg, xt[:, :62])
    got, state = tfwd(tp, cfg, xt[:, 62:], state=state)
    close(got, want)
    close(state, wstate)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_xlstm_decode_step_matches_jax(kind):
    specs, _, jstep, jinit, tfwd, tstep, tinit = MIXERS[kind]
    jcfg = jax_get_config("xlstm-125m").smoke()
    cfg, jp, tp = block("xlstm-125m", specs)
    x, xt = inputs(cfg.d_model, n=10)
    jstate, state = jinit(jcfg, B), tinit(cfg, B)
    close(state, jstate)
    for t in range(x.shape[1]):
        want, jstate = jstep(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jstate)
        got, state = tstep(tp, cfg, xt[:, t:t + 1], state)
        close(got, want)
        close(state, jstate)
    full, _ = tfwd(tp, cfg, xt)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the scans' inputs taken apart once: the forward as before, the backward
# linear in the sequence
# ---------------------------------------------------------------------------

SCANS = {
    "mamba": ("jamba-v0.1-52b", jax_ssm.mamba_specs, jax_ssm.mamba_forward,
              ssm.mamba_forward, ssm),
    "mlstm": ("xlstm-125m", jax_xlstm.mlstm_specs, jax_xlstm.mlstm_forward,
              xlstm.mlstm_forward, xlstm),
    "slstm": ("xlstm-125m", jax_xlstm.slstm_specs, jax_xlstm.slstm_forward,
              xlstm.slstm_forward, xlstm),
}


def _select_scan(step, init, xs, *, chunk_size):
    """``chunked_scan`` as it read its inputs before: step t selected
    ``x[t]`` from the whole padded input, and each chunk's checkpoint took
    the whole input, so that every select's backward added a zero gradient
    as large as the input."""
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.scan_utils import _leaves, _map

    L = _leaves(xs)[0].shape[0]
    c = min(chunk_size, L)
    pad = (-L) % c
    if pad:
        xs = _map(lambda x: F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)), xs)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(init) + _leaves(xs))

    def scan(step, carry, xs, start, n):
        ys = []
        for t in range(start, start + n):
            carry, y = step(carry, _map(lambda x: x[t], xs))
            ys.append(y)
        return carry, _map(lambda *a: torch.stack(a), *ys)

    carry, chunks = init, []
    for start in range(0, L + pad, c):
        if remat:
            carry, ys = checkpoint(scan, step, carry, xs, start, c, use_reentrant=False)
        else:
            carry, ys = scan(step, carry, xs, start, c)
        chunks.append(ys)
    return carry, _map(lambda *a: torch.cat(a)[:L], *chunks)


def _mixer_grads(fwd, cfg, tp, xt, w):
    """(output, gradients of x and every weight) of ``sum(out * w)``."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = xt.clone().requires_grad_(True)
    out, _ = fwd(leaves, cfg, x, chunk_size=16)
    grads = torch.autograd.grad((out * w).sum(), [x] + list(leaves.values()))
    return out.detach(), dict(zip(["x"] + list(leaves), grads))


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_scan_forward_as_before_and_gradients_match_jax(kind, monkeypatch):
    """Each mixer over 70 tokens in chunks of 16 (the last padded): the
    output bitwise the select-a-step loop's, and the gradients of the input
    and every weight those of ``jax.grad`` of the JAX package's mixer within
    1e-4 of the largest gradient entry (the 1e-4 of
    ``test_chunked_scan_matches_jax``, on the scale of the whole gradient:
    the mLSTM gate biases' gradients cancel to ~1e-6, where the two
    packages' summation orders part)."""
    arch, specs, jfwd, tfwd, module = SCANS[kind]
    jcfg = jax_get_config(arch).smoke()
    cfg, jp, tp = block(arch, specs)
    x, xt = inputs(cfg.d_model, n=70)
    w = np.random.default_rng(9).normal(size=(B, 70, cfg.d_model)).astype(np.float32)
    out, grads = _mixer_grads(tfwd, cfg, tp, xt, torch.from_numpy(w))
    monkeypatch.setattr(module, "chunked_scan", _select_scan)
    before, _ = _mixer_grads(tfwd, cfg, tp, xt, torch.from_numpy(w))
    assert torch.equal(out, before)

    def jloss(p, x):
        return (jfwd(p, jcfg, x, chunk_size=16)[0] * w).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    want = dict(to_np(jgp), x=np.asarray(jgx))
    assert sorted(grads) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k, g in grads.items():
        assert np.abs(g.numpy() - want[k]).max() <= 1e-4 * scale, k


def test_scan_backward_traffic_is_linear_in_the_sequence(monkeypatch):
    """The bytes a Mamba block's forward and backward move (counted op by
    op, ``launch.trace_analysis``) at 256 tokens are at most 2.1x those at
    128 (chunks of 16); the select-a-step loop's grew about as the square."""
    from repro_torch.launch.trace_analysis import analyze_step

    cfg, _, tp = block("jamba-v0.1-52b", jax_ssm.mamba_specs)

    def traffic():
        out = []
        for n in (128, 256):
            xt = torch.zeros(B, n, cfg.d_model)
            out.append(analyze_step(
                lambda p, x: _mixer_grads(ssm.mamba_forward, cfg, p, x, 1.0), tp,
                xt)[1].eager_bytes)
        return out[1] / out[0]

    assert traffic() <= 2.1
    monkeypatch.setattr(ssm, "chunked_scan", _select_scan)
    assert traffic() > 3.0
