"""One run of a cell: set-up, the timed fit, the traced slice, and the
check of what the timed path produced against the plain reference.

Set-up (``setup``) makes the counts from the seed, reads and normalizes
them as ``dca()`` does (``read_dataset``, ``normalize`` with the lazy
z-scale where ``dca()`` takes it), builds the network of the
configuration, writes the harness's seeded weights into it, and runs the
warm-up fit: one ``train()`` epoch on the cell's data and shapes, which
builds or loads the kernels, captures the step graphs, and is the fit the
check follows; then ``more_states`` makes a few one-epoch ``train()``
calls on the same network, each a further state the check reads the
program at.  The timed fit is one more ``train()`` call on the same
network, ``early_stop=0``, of as many epochs as fill about ``seconds`` at
the median of those set-up epochs' times; in a traced run inside
``dca_tpu_torch.timeline.recording()`` up to the profiler's start, whose
record the metric readers get.  Every fit is ``train()``'s own: its size
gate chooses the trainer (in memory, or streamed in parts) and the
streaming trainer its staging tier, as under ``dca()``; a traced run's
record shows which.  Sparse counts stay sparse through set-up.

The check (``check``) runs once the window has closed and the program's
state is freed: the reference follows the warm-up epoch from the same
weights and rows, and evaluates the validation split at each state the
program reached; ``compare`` turns both into the numbers held to the
cell's limits.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np

from . import arith, reference, traffic


# ---------------------------------------------------------------------------
# seeds and weights
# ---------------------------------------------------------------------------


def derive_seeds(seed):
    """Seeds of the data, the weights and the fit's row orders, each below
    2**31, drawn from ``seed`` (any non-negative integer)."""
    data, weights, fit = np.random.SeedSequence(int(seed)).generate_state(3)
    return {"data": int(data) >> 1, "weights": int(weights) >> 1, "fit": int(fit) >> 1}


def layer_names(hidden):
    """The trunk's layer names, as the network names its parameters:
    ``enc<i>`` before the centre, ``center``, ``dec<i>`` after it."""
    c = len(hidden) // 2
    return [f"enc{i}" if i < c else "center" if i == c else f"dec{i - c}"
            for i in range(len(hidden))]


def head_names(config):
    return ["mean", "dispersion"] + (["pi"] if config["ae_type"].startswith("zinb") else [])


def make_weights(config, genes, seed, device):
    """{name: tensor}: Glorot-uniform kernels drawn on ``device`` from one
    generator in one call, zero biases and BatchNorm offsets."""
    import torch

    hidden = config["hidden_size"]
    shapes = {}
    prev = genes
    for name, h in zip(layer_names(hidden), hidden):
        shapes[f"trunk.{name}.kernel"] = (prev, h)
        prev = h
    for head in head_names(config):
        shapes[f"heads.{head}.kernel"] = (prev, genes)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(a * b for a, b in shapes.values())
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (a, b) in shapes.items():
        limit = math.sqrt(6.0 / (a + b))
        out[name] = (u[at:at + a * b].view(a, b) * (2.0 * limit) - limit).contiguous()
        at += a * b
        bias = name[:-len("kernel")] + "bias"
        out[bias] = torch.zeros(b, device=device)
        if name.startswith("trunk."):
            out[name[:-len("kernel")] + "bn_beta"] = torch.zeros(b, device=device)
    return out


def load_weights(net, weights):
    """Write ``weights`` into the program's network, BatchNorm's moving
    statistics at 0 and 1; the names have to match the network's."""
    import torch

    params = dict(net.model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the network's parameters {sorted(params)} are not the "
                           f"configuration's {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
        for name, b in net.model.named_buffers():
            b.fill_(1.0 if name.endswith("moving_var") else 0.0)


def snapshot(net):
    """(parameters, {layer: (moving mean, moving var)}) cloned."""
    params = {k: v.detach().clone() for k, v in net.model.named_parameters()}
    moving = {}
    for name, b in net.model.named_buffers():
        parts = name.split(".")
        if parts[0] == "trunk":
            m, v = moving.get(parts[1], (None, None))
            moving[parts[1]] = ((b.detach().clone(), v) if parts[2] == "moving_mean"
                                else (m, b.detach().clone()))
    return params, moving


# ---------------------------------------------------------------------------
# set-up and the fits
# ---------------------------------------------------------------------------


def fit_kwargs(config):
    return dict(batch_size=config["batch_size"], optimizer=config["optimizer"],
                learning_rate=config["learning_rate"], reduce_lr=config["reduce_lr"],
                clip_grad=config["clip_grad"], validation_split=config["validation_split"],
                early_stop=0, verbose=False)


class Setup:
    """What set-up made: the raw counts, the normalized data, the network
    and the warm-up fit's history and states."""


def setup(cell, seed, device):
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.data.io import _col_sums, auto_lazy_scale, normalize, read_dataset
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train.loop import train

    s = Setup()
    s.seeds = derive_seeds(seed)
    cfg, tr = cell.config, cell.traffic
    s.times = {}
    t0 = time.perf_counter()
    s.counts = traffic.make_counts(tr, s.seeds["data"])
    s.times["data_s"] = time.perf_counter() - t0
    sparse = hasattr(s.counts, "tocsr")
    # normalize() leaves a sparse X in place and builds new matrices
    adata = AnnData(s.counts if sparse else s.counts.copy())
    adata = read_dataset(adata, transpose=False, test_split=False, check_counts=True)
    if not (_col_sums(adata.X) >= 1).all():
        raise ValueError("the traffic made an all-zero gene, which dca() refuses")
    adata = normalize(adata, filter_min_counts=False, size_factors=True,
                      normalize_input=True, logtrans_input=True,
                      lazy_scale=auto_lazy_scale(adata))
    s.adata = adata
    s.times["normalize_s"] = time.perf_counter() - t0 - s.times["data_s"]
    genes = adata.n_vars
    s.genes = genes
    net = get_ae_type(cfg["ae_type"])(
        input_size=genes, output_size=genes, hidden_size=tuple(cfg["hidden_size"]),
        hidden_dropout=cfg["hidden_dropout"], batchnorm=cfg["batchnorm"],
        activation=cfg["activation"], init=cfg["init"], seed=s.seeds["weights"],
        device=device)
    net.build()
    s.weights = make_weights(cfg, genes, s.seeds["weights"], device)
    load_weights(net, s.weights)
    s.net = net
    s.n = adata.n_obs
    s.n_train = int(s.n * (1.0 - cfg["validation_split"]))
    s.timeline = None
    t1 = time.perf_counter()
    s.warm = train(adata, net, epochs=1, seed=s.seeds["fit"], **fit_kwargs(cfg))
    s.after = snapshot(net)
    s.states = [("warm", s.after + (s.warm.history["val_loss"][0],))]
    s.epoch_s = [s.warm.epoch_s[0]]
    s.times["warm_fit_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    more_states(s, cell)
    s.times["state_fits_s"] = time.perf_counter() - t1
    return s


def epochs_for(seconds, epoch_s):
    """Epochs of the timed fit: about ``seconds`` at the median of the
    set-up's epoch times ``epoch_s`` (one of them may take twice the
    others)."""
    return max(1, int(round(seconds / max(float(np.median(epoch_s)), 1e-6))))


def timed_fit(s, cell, seconds, tracer=None, record=False):
    """The window: one ``train()`` call; returns (history, wall seconds,
    epochs).  ``tracer``: a ``trace.SliceTracer`` the fit's points of
    progress drive.  ``record``: the call inside the program's
    ``timeline.recording()``, whose record goes to ``s.timeline``; with a
    ``tracer``, up to the point where the profiler starts."""
    import torch

    from dca_tpu_torch import timeline
    from dca_tpu_torch.train.loop import train

    epochs = epochs_for(seconds, s.epoch_s)
    cuda = s.net.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    slicing = contextlib.nullcontext()
    if tracer is not None:
        from dca_tpu_torch.parallel.launch import posting

        slicing = posting(tracer)
        tracer.arm()
    window = contextlib.ExitStack()
    rec = window.enter_context(timeline.recording()) if record else None
    if rec is not None and tracer is not None:
        # the record ends before the profiler starts: the slice runs as it
        # would without the recorder, whose readers take the epochs before
        tracer.before_start = window.close
    t0 = time.perf_counter()
    with slicing, window:
        hist = train(s.adata, s.net, epochs=epochs, seed=s.seeds["fit"],
                     **fit_kwargs(cell.config))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s.timeline = rec
    return hist, wall, epochs


def epochs_before(epoch_s, wall, seconds):
    """How many of a fit's epochs (walls ``epoch_s``, the call's ``wall``)
    had surely ended ``seconds`` after its call started: the call's time
    outside its epochs (the graphs' capture, the data's upload) taken as
    spent before the first, and one epoch less for the edge."""
    t = max(wall - sum(epoch_s), 0.0)
    k = 0
    for e in epoch_s:
        t += e
        if t > seconds:
            break
        k += 1
    return max(k - 1, 0)


def trainer_seen(record):
    """(trainer, tier) as the program's record of a fit shows them: the
    streaming trainer by its ``dca.stream.*`` spans, the in-memory one by
    ``dca.fit.steps``; a streamed fit's staging tier "resident" where no
    part was prepared on the prefetch thread (no ``dca.stream.prep``:
    the resident tier stages on the fit's thread, ``train()``'s
    docstring), else "prefetch".  (None, None) without a record."""
    if record is None:
        return None, None
    names = {span.name for span in record.spans}
    if any(n.startswith("dca.stream.") for n in names):
        return "streaming", "prefetch" if "dca.stream.prep" in names else "resident"
    return ("in_memory", None) if "dca.fit.steps" in names else (None, None)


def schedule(cell, s, trainer):
    """The loss kernels' shapes in an epoch of a fit on ``trainer`` (as the
    record shows it, ``trainer_seen``): the batch, the trailing step's rows
    and the validation's rows in the chunks the fit evaluates them in: one
    in memory; None on the streaming trainer, whose chunks the record does
    not give (their launches are then left unlabelled)."""
    bs = min(cell.config["batch_size"], max(s.n_train, 1))
    n_val = s.n - s.n_train
    chunks = None if trainer == "streaming" else [n_val] if n_val else []
    return {"batch": bs, "rem": s.n_train % bs, "val_chunks": chunks}


def model_flops(cell, s, epochs):
    """Matrix-product FLOPs of ``epochs`` epochs: each training row's step
    and each validation row's forward."""
    hidden = cell.config["hidden_size"]
    heads = len(head_names(cell.config))
    return epochs * (s.n_train * arith.train_flops_per_row(s.genes, hidden, heads)
                     + (s.n - s.n_train) * arith.forward_flops_per_row(s.genes, hidden, heads))


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def release(s):
    """Free the program's state before the reference runs."""
    import torch

    s.net = None
    s.adata = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_epoch(cell, s, device, precision="f32", fault=None, inputs=None):
    """The reference's first epoch from the set-up's weights; returns
    (inputs, result)."""
    cfg = cell.config
    if inputs is None:
        inputs = reference.inputs_of(s.counts, device)
    res = reference.first_epoch(
        inputs, s.weights, layer_names(cfg["hidden_size"]), head_names(cfg),
        seed=s.seeds["fit"], batch_size=cfg["batch_size"],
        validation_split=cfg["validation_split"], lr=cfg["learning_rate"],
        clip=cfg["clip_grad"], precision=precision, fault=fault)
    return inputs, res


def compare(cell, s, program, ref, states):
    """The numbers the check holds to the limits.

    ``program``: {"loss", "val_loss", "params"} of the program's warm-up
    epoch; ``ref``: the reference's ``first_epoch``; ``states``: {name:
    gap} of the program's validation loss at each state it reached
    against the judge's at that state (``state_gaps``).

    * ``loss_gap``: the epoch's training loss, |program - reference| /
      reference;
    * ``state_gap``: the largest of ``states``: a mean over 0.9M
      validation elements moves under TF32 by 1e-8 to 9e-6 of itself, by
      chance little at one state;
    * ``leaf_gap``: the median leaf's gap between the norms of the
      program's and the reference's change over the epoch, each leaf's
      over the larger of the reference's norm of that leaf and of the
      median leaf; leaves whose first gradient in the reference is under a
      thousandth of the median leaf's (a Dense bias before BatchNorm:
      nought to rounding) are left out.  The median, not the worst leaf:
      on a float32 trajectory that rounding has parted from the
      reference's, the worst leaf reads 2-27 times the median, as far as
      half of a batch left out moves it, while half a batch moves every
      leaf (PERF.md); the worst is in the detail.

    The gap of the epoch's validation losses goes to the detail alone: it
    separates neither the control nor a fault from sound runs (PERF.md)."""
    import torch

    g0 = ref["grad0"]
    med_g = float(np.median(list(g0.values())))
    leaves = sorted(k for k, v in g0.items() if v >= 1e-3 * med_g)
    w0 = s.weights

    def norm(a, b):
        return float(torch.linalg.vector_norm((a.to(b.device) - b).double()))

    d_ref = {k: norm(ref["params"][k], w0[k]) for k in leaves}
    d_prog = {k: norm(program["params"][k], w0[k]) for k in leaves}
    med_d = float(np.median(list(d_ref.values())))
    gaps = {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med_d) for k in leaves}
    leaf_gap = float(np.median(list(gaps.values())))
    worst = max(gaps, key=gaps.get)

    def rel(a, b):
        return abs(a - b) / abs(b) if b else math.inf

    numbers = {
        "loss_gap": rel(program["loss"], ref["loss"]),
        "state_gap": max(states.values()),
        "leaf_gap": leaf_gap,
    }
    numbers = {k: (v if math.isfinite(v) else math.inf) for k, v in numbers.items()}
    detail = {"worst_leaf": worst, "worst_leaf_gap": gaps[worst], "leaves": len(leaves),
              "left_out": sorted(set(g0) - set(leaves)),
              "val_gap": rel(program["val_loss"], ref["val_loss"]), "leaf_gaps": gaps,
              "state_gaps": states}
    return numbers, detail


def program_readings(s):
    hist = s.warm.history
    params, _ = s.after
    return {"loss": hist["loss"][0], "val_loss": hist["val_loss"][0], "params": params}


def keep_final(s, hist):
    """The state the timed fit ended in, and its last validation loss."""
    s.states.append(("final", snapshot(s.net) + (hist.history["val_loss"][-1],)))


def more_states(s, cell):
    """The traffic's ``state_fits`` one-epoch ``train()`` calls on the
    program's network after the warm-up, each on its own row order: the
    state each ends in, with its validation loss, joins ``s.states``, its
    epoch time ``s.epoch_s``.
    A single state's validation mean moves under TF32 by as little as
    float32 rounding moves it (PERF.md); over several states the control's
    largest gap stands clear of the program's."""
    from dca_tpu_torch.train.loop import train

    for i in range(cell.traffic.get("state_fits", 0)):
        hist = train(s.adata, s.net, epochs=1, seed=(s.seeds["fit"] + 1 + i) % 2**31,
                     **fit_kwargs(cell.config))
        s.states.append((f"fit{i + 1}", snapshot(s.net) + (hist.history["val_loss"][0],)))
        s.epoch_s.append(hist.epoch_s[0])


def state_gaps(cell, s, inputs):
    """(gaps, control): the program's validation loss at each state it
    reached (``s.states``: the warm-up's, those of ``more_states``, the
    timed fit's last) against the float64 judge at that state, by the
    state's name; beside them the control's, a TF32 forward at the same
    states."""
    cfg = cell.config
    layers, heads = layer_names(cfg["hidden_size"]), head_names(cfg)
    gaps, control = {}, {}
    for name, (params, moving, val_loss) in s.states:
        judge = reference.eval_at(inputs, params, moving, layers, heads, s.n_train)
        tf32 = reference.eval_at(inputs, params, moving, layers, heads, s.n_train, "tf32")
        gaps[name] = abs(val_loss - judge) / judge
        control[name] = abs(tf32 - judge) / judge
    return gaps, control


def check(cell, s, device):
    """(numbers, detail): the warm-up epoch against the reference
    (``compare``) and the validation loss at the states the program
    reached against the judge's (``state_gaps``).  The detail holds the
    control's ``state_gap`` at those states, judged by the cell's limits
    as the program's is (``control["correct"]``, false where the limit
    catches TF32)."""
    prog = program_readings(s)
    inputs, ref = reference_epoch(cell, s, device)
    states, control = state_gaps(cell, s, inputs)
    numbers, detail = compare(cell, s, prog, ref, states)
    worst = max(control.values())
    detail["control"] = {"state_gaps": control, "state_gap": worst,
                         "correct": judge({"state_gap": worst}, cell.limits)}
    return numbers, detail


def judge(numbers, limits):
    """True when every number is within its limit."""
    return all(numbers[k] <= limits[k]["limit"] for k in numbers)
