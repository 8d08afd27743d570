"""The loss backward K2 (and K2w) of the PyTorch port on the CPU: its plain
version, which takes the incoming gradient g and the forward's
denominator and forms g / denom itself as the kernel does, against the
JAX package's backward Pallas kernel in interpret mode fed scale =
g / denom; ``_FusedNLL`` with a non-unit incoming gradient against
autograd of the plain loss; the wrapper's refusal of CPU tensors, with no
launch counted; and the C signatures the wrappers bind
against the kernels' sources.  The kernel itself is compared with the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dca_tpu.ops import fused_loss as jfused

from dca_tpu_torch.ops import _build, fused_loss

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

G_BWD = np.float32(0.37)


def _inputs(B, G, th_shape, pi_shape, seed):
    """The inputs of tests/test_pallas.py with 10% NaN targets and two
    clipped thetas; theta and pi of the given shapes (pi None for NB).
    With pi, a clipped theta's targets are not 0: the ZINB zero case at
    theta = 1e6 takes exp(theta (log theta - log(theta + mu))), whose
    float32 logs cancel to noise that two libraries round apart."""
    rs = np.random.RandomState(seed)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.3] = 0.0
    y[rs.uniform(size=y.shape) < 0.1] = np.nan
    mu = rs.uniform(0.1, 8.0, size=(B, G)).astype(np.float32)
    th = rs.uniform(0.1, 5.0, size=th_shape).astype(np.float32)
    if th.size > 2:
        th.reshape(-1)[:2] = (2e6, 5e6)
    pi = None if pi_shape is None else rs.uniform(0.05, 0.7, size=pi_shape).astype(np.float32)
    if pi is not None:
        y[np.broadcast_to(th > 1e6, y.shape) & (y == 0.0)] = 1.0
    return y, mu, th, pi


def _t(a, grad=False):
    return None if a is None else torch.tensor(a, dtype=torch.float32, requires_grad=grad)


KINDS = {"full": lambda B, G: (B, G), "row": lambda B, G: (1, G),
         "col": lambda B, G: (B, 1), "scalar": lambda B, G: (1, 1)}
# (theta, pi) kinds: NB with every theta, ZINB with full and broadcast pairs
CASES = ([(th, None) for th in KINDS]
         + [("full", "full"), ("row", "full"), ("col", "col"), ("row", "row"),
            ("col", "row"), ("scalar", "scalar"), ("full", "scalar")])


@pytest.mark.parametrize("weighted", [False, True], ids=["K2", "K2w"])
@pytest.mark.parametrize("th_kind,pi_kind", CASES)
def test_plain_backward_matches_jax_pallas_bwd(th_kind, pi_kind, weighted):
    """The plain K2/K2w with (g, denom) against ``dca_tpu``'s
    ``_pallas_bwd`` in interpret mode with scale = g / denom, at the
    tolerances tests/test_pallas.py holds the fused gradients to."""
    B, G = 12, 40
    y, mu, th, pi = _inputs(B, G, KINDS[th_kind](B, G),
                            None if pi_kind is None else KINDS[pi_kind](B, G),
                            seed=CASES.index((th_kind, pi_kind)))
    w = None
    if weighted:
        w = np.random.RandomState(3).uniform(0.2, 2.0, size=(B, 1)).astype(np.float32)
        w[[0, 5]] = 0.0
    ridge = 0.0 if pi is None else 0.05
    _, denom = fused_loss._fwd_reference(_t(y), _t(mu), _t(th), _t(pi), ridge, _t(w))
    got = fused_loss._bwd_reference(_t(y), _t(mu), _t(th), _t(pi), ridge,
                                    torch.tensor(G_BWD), denom, _t(w))
    scale = G_BWD / np.float32(denom.item())  # one float32 division, as K2's
    assert np.float32(scale) == (torch.tensor(G_BWD) / denom).item()
    want = jfused._pallas_bwd(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(th),
                              None if pi is None else jnp.asarray(pi), ridge,
                              jnp.asarray(np.float32(scale)), True,
                              w=None if w is None else jnp.asarray(w))
    for name, a, b in zip(("mu", "theta", "pi"), got, [x for x in want if x is not None]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=1e-5,
                                   err_msg=name)
    if th_kind == "full":
        assert got[1][0, 0].item() == 0.0 and got[1][0, 1].item() == 0.0  # clipped theta
    if weighted:
        zero = np.isnan(y) | (w == 0.0)
        assert all(np.all(a.numpy()[zero] == 0.0) for a in got if a.shape == (B, G))


@pytest.mark.parametrize("family,weighted", [("nb", False), ("zinb", False), ("nb", True),
                                             ("zinb", True)])
def test_fused_non_unit_incoming_gradient_matches_autograd(family, weighted):
    """``_FusedNLL`` under loss * 0.37: the backward scales by the incoming
    gradient over the denominator, as autograd of the plain loss does, and
    is 0.37 times the backward under the loss alone."""
    B, G = 16, 64
    y, mu, th, pi = _inputs(B, G, (B, G), (B, G) if family == "zinb" else None, seed=21)
    w = (None if not weighted
         else np.random.RandomState(21).uniform(0.0, 2.0, size=(B, 1)).astype(np.float32))
    ops = [_t(a, True) for a in (mu, th, pi) if a is not None]
    args = (_t(y), ops[0], ops[1], ops[2] if pi is not None else None, _t(w), 0.05, None)
    loss = fused_loss._FusedNLL.apply(*args)
    got = torch.autograd.grad(loss * float(G_BWD), ops, retain_graph=True)
    unit = torch.autograd.grad(loss, ops)
    if pi is None:
        ref = (fused_loss.nb_nll_fused_reference(_t(y), *ops) if w is None
               else fused_loss.nb_nll_fused_w_reference(_t(y), *ops, _t(w)))
    else:
        ref = (fused_loss.zinb_nll_fused_reference(_t(y), *ops, 0.05) if w is None
               else fused_loss.zinb_nll_fused_w_reference(_t(y), *ops, _t(w), 0.05))
    refs = torch.autograd.grad(ref * float(G_BWD), ops)
    for a, r, u in zip(got, refs, unit):
        # digamma from its own series vs autograd's derivative of the
        # lgamma series, as test_torch_ops.py holds them
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(a.numpy(), u.numpy() * G_BWD, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("family", ["nb", "zinb"])
@pytest.mark.parametrize("B,G", [(7, 50), (25, 64)], ids=["ragged", "trailing"])
def test_plain_backward_matches_jax_at_the_card_test_shapes(B, G, family):
    """The plain K2 at a ragged shape and at a trailing step's row count
    (the shapes tests/test_torch_gpu.py launches K2 at, narrower) against
    ``dca_tpu``'s ``_pallas_bwd`` in interpret mode, full theta and pi."""
    y, mu, th, pi = _inputs(B, G, (B, G), (B, G) if family == "zinb" else None, seed=B + G)
    ridge = 0.0 if pi is None else 0.1
    _, denom = fused_loss._fwd_reference(_t(y), _t(mu), _t(th), _t(pi), ridge)
    got = fused_loss._bwd_reference(_t(y), _t(mu), _t(th), _t(pi), ridge,
                                    torch.tensor(G_BWD), denom)
    scale = (torch.tensor(G_BWD) / denom).item()
    want = jfused._pallas_bwd(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(th),
                              None if pi is None else jnp.asarray(pi), ridge,
                              jnp.asarray(np.float32(scale)), True)
    for name, a, b in zip(("mu", "theta", "pi"), got, [x for x in want if x is not None]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["nb", "zinb"])
@pytest.mark.parametrize("weighted", [False, True], ids=["K2", "K2w"])
def test_k2_wrapper_refuses_cpu_tensors_and_counts_nothing(family, weighted):
    """The K2 wrapper launches only on CUDA tensors: on CPU ones it raises
    before anything is counted, and ``_FusedNLL`` on the CPU runs the plain
    backward, which counts no launch either."""
    B, G = 4, 12
    y, mu, th, pi = _inputs(B, G, (B, G), (B, G) if family == "zinb" else None, seed=9)
    w = _t(np.ones((B, 1), np.float32)) if weighted else None
    fused_loss.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss._bwd_kernel(_t(y), _t(mu), _t(th), _t(pi), 0.0,
                               torch.tensor(G_BWD), torch.tensor(1.0), w)
    ops = [_t(a, True) for a in (mu, th, pi) if a is not None]
    loss = fused_loss._FusedNLL.apply(_t(y), ops[0], ops[1],
                                      ops[2] if pi is not None else None, w, 0.0, None)
    torch.autograd.grad(loss, ops)
    assert set(fused_loss.launches.values()) == {0}


def test_plain_backward_divides_as_the_kernel_does():
    """scale = g / denom, then each gradient times it: the bits of the
    former two-step form, (g / denom) computed apart and passed in."""
    y, mu, th, pi = _inputs(6, 30, (6, 30), (6, 30), seed=5)
    g, denom = torch.tensor(G_BWD), torch.tensor(173.0)
    got = fused_loss._bwd_reference(_t(y), _t(mu), _t(th), _t(pi), 0.05, g, denom)
    grads = fused_loss._elem_grads(_t(y), _t(mu), _t(th), _t(pi), 0.05)
    for a, d in zip(got, grads):
        assert torch.equal(a, d * (g / denom))


def _c_parameters(source, name):
    """The parameter types of ``int name(...)`` in a CUDA source, in order."""
    m = re.search(rf"\n\w[\w\s\*]*\b{name}\(([^)]*)\)\s*\{{", source)
    assert m, name
    params = [" ".join(p.split()) for p in m.group(1).split(",") if p.strip()]
    # the type is what precedes the parameter's name
    return [re.sub(r"\s*\b\w+$", "", p).replace("const ", "") for p in params]


_CTYPES = {ctypes.c_void_p: "*", ctypes.c_longlong: "long long", ctypes.c_int: "int",
           ctypes.c_float: "float"}


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signatures_match_the_sources(name):
    """Each C entry point takes the arguments, in number and kind, that
    ``_build._SIGNATURES`` declares for ctypes: a pointer for a pointer,
    an integer of the same width, a float for a float."""
    source = "".join(open(os.path.join(_build.CSRC_DIR, f)).read() for f in _build.SOURCES)
    argtypes, _ = _build._SIGNATURES[name]
    got = _c_parameters(source, name)
    assert len(got) == len(argtypes), (name, got)
    for c_type, arg in zip(got, argtypes):
        want = _CTYPES.get(arg, "*")  # POINTER(c_int) is a pointer too
        assert (c_type.endswith("*") if want == "*" else c_type == want), (name, c_type, arg)


def test_reset_launches_clears_the_counts():
    fused_loss.launches["zinb_nll_bwd"] += 3
    fused_loss.reset_launches()
    assert set(fused_loss.launches.values()) == {0}
