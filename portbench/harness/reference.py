"""The plain reference of a DCA fit: float32 PyTorch and autograd, no
kernel of its own and no cache, written from the published model (Eraslan et al.
2019; theislab/dca ``network.py``, ``loss.py``, ``io.py``) and Keras's
layers and RMSprop.  It imports nothing of the port and nothing of JAX.

From the raw counts it works out the model's input (size factors, log1p,
the per-gene z-scale with ddof 1): all of it at once from a dense array
(``Inputs``), or from a CSR matrix kept sparse on the device, the rows a
step or a block takes made dense as it takes them (``SparseInputs``,
the same values bit for bit).  Then it follows a fit's first epoch from
the given weights: the rows in the order ``RandomState(seed).permutation``
gives (Keras's seeded shuffle), full batches then the trailing one, each
a training-mode forward (BatchNorm on the batch's biased statistics,
moving averages at momentum 0.99, eps 1e-3), the NB or ZINB likelihood's
mean, its gradient by autograd, each element clipped to +-5, and
RMSprop (rho 0.9, eps 1e-7 outside the root); then the validation loss
in eval mode on the tail rows.

``precision="tf32"`` lets the matrix products round their operands to
TF32 (the control: the nearest precision below the configuration's
float32); ``fault`` plants one of the faults the check has to catch.  On
a CUDA device the epoch's full steps replay one captured step (a CUDA
graph of these same operations), to keep the check short.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

EPS = 1e-10
THETA_CLIP = 1e6
ZERO_THRESHOLD = 1e-8
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
RHO = 0.9
RMS_EPS = 1e-7

FAULTS = (None, "half_batch", "loss_scale")
# the elements of an evaluation block: a float64 forward's dozen
# intermediates of this size fit beside the rest on the card
EVAL_ELEMENTS = 1 << 27
# the "answer altered where it is produced" fault: the likelihood's value
# off by this factor
LOSS_SCALE = 1.01


# ---------------------------------------------------------------------------
# the model's input
# ---------------------------------------------------------------------------


class Inputs:
    """The model's input rows and the loss's targets, on ``device``: the
    raw counts (target) and the normalized input, both dense float32,
    built block by block from a dense array of counts."""

    def __init__(self, counts, device, block=16384):
        n, g = counts.shape
        self.n, self.genes = n, g
        totals = counts.sum(axis=1).astype(np.float64)
        median = np.median(totals)
        # size factors: total / median total (scanpy normalize_per_cell)
        self.sf = torch.from_numpy((totals / median).astype(np.float32)).to(device)
        scale = median / totals
        self.target = torch.empty((n, g), dtype=torch.float32, device=device)
        self.x = torch.empty((n, g), dtype=torch.float32, device=device)
        s1 = torch.zeros(g, dtype=torch.float64, device=device)
        s2 = torch.zeros(g, dtype=torch.float64, device=device)
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            t = torch.from_numpy(np.asarray(counts[lo:hi], dtype=np.float32)).to(device)
            self.target[lo:hi] = t
            sc = torch.from_numpy(scale[lo:hi]).to(device)
            logn = torch.log1p(t.double() * sc[:, None])
            s1 += logn.sum(0)
            s2 += (logn * logn).sum(0)
            self.x[lo:hi] = logn.float()
        mean, std = _moments(s1, s2, n)
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            self.x[lo:hi] = ((self.x[lo:hi].double() - mean) / std).float()

    @property
    def device(self):
        return self.x.device

    def rows(self, idx):
        """(input, target) of the rows ``idx`` (a device tensor)."""
        return self.x.index_select(0, idx), self.target.index_select(0, idx)

    def block(self, lo, hi):
        """(input, target) of the rows lo..hi."""
        return self.x[lo:hi], self.target[lo:hi]


def _moments(s1, s2, n):
    """The per-gene mean and standard deviation (ddof 1; 1 where it is 0)
    from the sums of the log counts and of their squares over ``n`` rows."""
    mean = s1 / n
    var = (s2 / n - mean * mean) * (n / max(n - 1, 1))  # ddof 1
    std = torch.sqrt(torch.clamp(var, min=0.0))
    std[std == 0] = 1.0
    return mean, std


class SparseInputs:
    """``Inputs`` of a CSR matrix of counts, which stays sparse on
    ``device``: the rows a step or an evaluation block takes are made
    dense when it takes them, with the values ``Inputs`` would hold for
    them, bit for bit (the same float64 size factors, log1p and ddof-1
    moments, the moments summed over the same blocks of dense rows).  A
    row is gathered as its first ``width`` stored entries, the widest
    row's count, the missing ones as zeros added to column 0, so that the
    gather has one shape and a CUDA graph can capture it."""

    def __init__(self, counts, device, block=16384):
        counts = counts.tocsr()
        n, g = counts.shape
        self.n, self.genes = n, g
        lens = np.diff(counts.indptr)
        rows = np.repeat(np.arange(n), lens)
        totals = np.bincount(rows, weights=counts.data.astype(np.float64), minlength=n)
        median = np.median(totals)
        self.sf = torch.from_numpy((totals / median).astype(np.float32)).to(device)
        self.scale = torch.from_numpy(median / totals).to(device)
        self.indptr = torch.from_numpy(counts.indptr.astype(np.int64)).to(device)
        self.indices = torch.from_numpy(counts.indices.astype(np.int32)).to(device)
        self.data = torch.from_numpy(counts.data.astype(np.float32)).to(device)
        self.width = torch.arange(max(int(lens.max()) if n else 1, 1), device=device)
        s1 = torch.zeros(g, dtype=torch.float64, device=device)
        s2 = torch.zeros(g, dtype=torch.float64, device=device)
        for lo in range(0, n, block):
            idx = torch.arange(lo, min(lo + block, n), device=device)
            cols, vals = self._gather(idx)
            logn = self._dense(cols, self._log(vals, idx), torch.float64)
            s1 += logn.sum(0)
            s2 += (logn * logn).sum(0)
        self.mean, self.std = _moments(s1, s2, n)

    @property
    def device(self):
        return self.data.device

    def _gather(self, idx):
        """(columns, values) of the rows ``idx``, ``width`` a row: the
        entries past a row's end at column 0 with value 0."""
        start = self.indptr.index_select(0, idx)
        end = self.indptr.index_select(0, idx + 1)
        pos = start[:, None] + self.width[None, :]
        inside = pos < end[:, None]
        pos = torch.where(inside, pos, torch.zeros_like(pos))
        cols = torch.where(inside, self.indices[pos].long(), torch.zeros_like(pos))
        vals = torch.where(inside, self.data[pos], torch.zeros((), device=pos.device))
        return cols, vals

    def _log(self, vals, idx):
        """log1p of the values times their rows' scale, in float64."""
        return torch.log1p(vals.double() * self.scale.index_select(0, idx)[:, None])

    def _dense(self, cols, vals, dtype):
        """The rows dense: each value added to a zero at its column (the
        zeros past a row's end add nothing)."""
        out = torch.zeros((cols.shape[0], self.genes), dtype=dtype, device=cols.device)
        return out.scatter_add_(1, cols, vals.to(dtype))

    def rows(self, idx):
        cols, vals = self._gather(idx)
        logn = self._dense(cols, self._log(vals, idx).float(), torch.float32)
        x = ((logn.double() - self.mean) / self.std).float()
        return x, self._dense(cols, vals, torch.float32)

    def block(self, lo, hi):
        return self.rows(torch.arange(lo, hi, device=self.device))


def inputs_of(counts, device):
    """``SparseInputs`` of a scipy sparse matrix of counts, ``Inputs`` of a
    dense one."""
    return SparseInputs(counts, device) if hasattr(counts, "tocsr") else Inputs(counts, device)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


class Net:
    """The autoencoder's parameters by name (``trunk.<layer>.kernel`` (in,
    out), ``.bias``, ``.bn_beta``; ``heads.<head>.kernel``, ``.bias``) and
    its BatchNorm moving statistics."""

    def __init__(self, params, layers, heads):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.layers = list(layers)  # trunk layer names in order
        self.heads = list(heads)  # "mean", "dispersion" and "pi" if ZINB
        self.loss_scale = 1.0  # LOSS_SCALE under the "loss_scale" fault
        self.moving = {name: (torch.zeros_like(self.p[f"trunk.{name}.bias"]),
                              torch.ones_like(self.p[f"trunk.{name}.bias"]))
                       for name in self.layers}

    @staticmethod
    def mm(a, b):
        return a @ b

    def forward(self, x, sf, training):
        """(mean * sf, theta, pi or None, the batch's BN statistics)."""
        stats = {}
        h = x
        for name in self.layers:
            z = self.mm(h, self.p[f"trunk.{name}.kernel"]) + self.p[f"trunk.{name}.bias"]
            if training:
                var, mu = torch.var_mean(z, 0, correction=0)  # biased, as Keras
                stats[name] = (mu.detach(), var.detach())
            else:
                mu, var = self.moving[name]
            z = (z - mu) / torch.sqrt(var + BN_EPS) + self.p[f"trunk.{name}.bn_beta"]
            h = torch.relu(z)
        mean = torch.clamp(torch.exp(self._head("mean", h)), 1e-5, 1e6)
        theta = torch.clamp(torch.nn.functional.softplus(self._head("dispersion", h)),
                            1e-4, 1e4)
        pi = torch.sigmoid(self._head("pi", h)) if "pi" in self.heads else None
        return mean * sf[:, None], theta, pi, stats

    def _head(self, name, h):
        return self.mm(h, self.p[f"heads.{name}.kernel"]) + self.p[f"heads.{name}.bias"]

    def commit_stats(self, stats):
        for name, (mu, var) in stats.items():
            m, v = self.moving[name]  # in place: a captured step updates them
            m.mul_(BN_MOMENTUM).add_(mu * (1.0 - BN_MOMENTUM))
            v.mul_(BN_MOMENTUM).add_(var * (1.0 - BN_MOMENTUM))


def likelihood(y, mu, theta, pi):
    """Mean NB (``pi`` None) or ZINB negative log-likelihood."""
    theta = torch.clamp(theta, max=THETA_CLIP)
    t1 = torch.lgamma(theta + EPS) + torch.lgamma(y + 1.0) - torch.lgamma(y + theta + EPS)
    t2 = ((theta + y) * torch.log(1.0 + mu / (theta + EPS))
          + y * (torch.log(theta + EPS) - torch.log(mu + EPS)))
    nb = t1 + t2
    if pi is None:
        return nb.mean()
    nb_case = nb - torch.log(1.0 - pi + EPS)
    zero_nb = torch.pow(theta / (theta + mu + EPS), theta)
    zero_case = -torch.log(pi + (1.0 - pi) * zero_nb + EPS)
    return torch.where(y < ZERO_THRESHOLD, zero_case, nb_case).mean()


@contextlib.contextmanager
def matmul_precision(precision):
    """float32 products ("f32"), or TF32 operands ("tf32") on a CUDA
    device; on the CPU "tf32" rounds each product's operands to TF32's
    10-bit mantissa, as the tensor cores take them."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _round_tf32(t):
    """t rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Net(Net):
    """``Net`` whose products round their operands to TF32 by hand (the
    control on a device without TF32 products, the CPU)."""

    @staticmethod
    def mm(a, b):
        return _RoundGrad.apply(a) @ _RoundGrad.apply(b)


class _RoundGrad(torch.autograd.Function):
    """TF32 rounding forward, and of the gradient backward (the backward
    products take TF32 operands too)."""

    @staticmethod
    def forward(ctx, t):
        return _round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


# ---------------------------------------------------------------------------
# the fit's first epoch
# ---------------------------------------------------------------------------


def first_epoch(inputs, params, layers, heads, *, seed, batch_size, validation_split, lr,
                clip, precision="f32", fault=None):
    """Follow the first epoch from ``params``; returns a dict: ``loss``
    (the epoch's, as the fit reports it: the steps' losses weighted by
    their rows), ``val_loss``, ``params`` (after the epoch),
    ``moving`` (BN statistics after it) and ``grad0`` ({name: norm of the
    first step's clipped gradient}).

    One function makes a step, in place: it takes its rows from the
    permutation by a step counter on the device.  On the CPU it runs step
    by step; on a CUDA device the first step runs eagerly (it also warms
    up the capture) and the other full steps replay it from a CUDA graph,
    so that the reference's time is not the host's dispatch of its ~200
    small operations a step."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    n = inputs.n
    n_train = int(n * (1.0 - validation_split))
    bs = min(batch_size, max(n_train, 1))
    n_full, rem = n_train // bs, n_train % bs
    dev = inputs.device
    cuda = dev.type == "cuda"
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(n_train)).to(dev)
    cpu_tf32 = precision == "tf32" and not cuda
    net = (_TF32Net if cpu_tf32 else Net)(params, layers, heads)
    net.loss_scale = LOSS_SCALE if fault == "loss_scale" else 1.0
    names = sorted(net.p)
    leaves = [net.p[k].requires_grad_(True) for k in names]
    acc = [torch.zeros_like(v) for v in leaves]
    weighted = torch.zeros((), dtype=torch.float64, device=dev)
    step_i = torch.zeros((), dtype=torch.int64, device=dev)
    grad0 = {}

    def kept(rows):
        """The rows of a batch the step takes: all, or half under the fault."""
        return torch.arange(max(rows // 2, 1) if fault == "half_batch" else rows, device=dev)

    def step(offsets, rows, first=False):
        idx = perm.index_select(0, offsets + step_i * bs)
        x, y = inputs.rows(idx)
        mu, theta, pi, stats = net.forward(x, inputs.sf.index_select(0, idx), True)
        loss = likelihood(y, mu, theta, pi) * net.loss_scale
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            grads = [torch.clamp(g, -clip, clip) for g in grads]
            if first:
                grad0.update({k: float(torch.linalg.vector_norm(g)) for k, g in zip(names, grads)})
            # RMSprop: a = rho a + (1 - rho) g^2; p -= lr g / (sqrt(a) + eps)
            torch._foreach_mul_(acc, RHO)
            torch._foreach_add_(acc, torch._foreach_mul(grads, grads), alpha=1.0 - RHO)
            denom = torch._foreach_sqrt(acc)
            torch._foreach_add_(denom, RMS_EPS)
            torch._foreach_sub_(leaves, torch._foreach_div(torch._foreach_mul(grads, lr), denom))
            net.commit_stats(stats)
            # the fit weighs a step's loss by its batch's rows
            weighted.add_(loss.detach().double() * rows)
            step_i.add_(1)

    full = kept(bs)
    with matmul_precision("f32" if cpu_tf32 else precision):
        if n_full:
            side = torch.cuda.Stream(dev) if cuda else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                step(full, bs, first=True)
            if cuda:
                torch.cuda.current_stream(dev).wait_stream(side)
            if cuda and n_full > 1:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    step(full, bs)
                for _ in range(n_full - 1):
                    graph.replay()
                del graph
            else:
                for _ in range(n_full - 1):
                    step(full, bs)
        if rem:
            step(kept(rem), rem, first=not n_full)
        train_loss = float(weighted) / max(n_train, 1)
        for v in leaves:
            v.requires_grad_(False)
        val_loss = eval_loss(inputs, net, n_train)
    return {"loss": train_loss, "val_loss": val_loss,
            "params": {k: v.detach() for k, v in net.p.items()},
            "moving": dict(net.moving), "grad0": grad0}


@torch.no_grad()
def eval_loss(inputs, net, start):
    """The eval-mode likelihood's mean over rows ``start``..n (the
    validation split), summed in blocks of at most ``EVAL_ELEMENTS``
    elements and 32768 rows."""
    dt = next(iter(net.p.values())).dtype
    block = max(min(32768, EVAL_ELEMENTS // inputs.genes), 1)
    total, count = 0.0, 0
    for lo in range(start, inputs.n, block):
        hi = min(lo + block, inputs.n)
        x, y = inputs.block(lo, hi)
        mu, theta, pi, _ = net.forward(x.to(dt), inputs.sf[lo:hi].to(dt), False)
        k = (hi - lo) * inputs.genes
        y = y.to(dt)
        total += float(likelihood(y, mu, theta, pi)) * net.loss_scale * k
        count += k
    return total / max(count, 1) if count else math.nan


def eval_at(inputs, params, moving, layers, heads, start, precision="f64"):
    """The validation loss of the state (``params``, ``moving``), the
    reference's own forward at a state it is handed: in float64 (the judge
    of a state; its own rounding far under the float32 program's), or
    "f32" or "tf32" (the control)."""
    dev = inputs.device
    cpu_tf32 = precision == "tf32" and dev.type != "cuda"
    dt = torch.float64 if precision == "f64" else torch.float32
    net = (_TF32Net if cpu_tf32 else Net)({k: v.to(dt) for k, v in params.items()},
                                          layers, heads)
    net.moving = {k: (m.detach().to(dt), v.detach().to(dt)) for k, (m, v) in moving.items()}
    with matmul_precision("tf32" if precision == "tf32" and not cpu_tf32 else "f32"):
        return eval_loss(inputs, net, start)
