"""What the readers of the program's record (``ctx.timeline``, a
``dca_tpu_torch.timeline.Record`` of the timed fit) share: which fit in
it is the timed one, and which of its epochs ran unprofiled."""


def main_fit(record):
    """The number of the record's fit with the most epochs, or None
    without a record or an epoch in it."""
    if record is None:
        return None
    counts = {}
    for s in record.spans:
        if s.name == "dca.fit.epoch":
            counts[s.fit] = counts.get(s.fit, 0) + 1
    return max(counts, key=counts.get) if counts else None


def unprofiled(fit):
    """A test of an epoch's number: True for the epochs that ended before
    the profiler's start was called (``fit["unprofiled_epochs"]`` of
    them), or for every epoch where none did."""
    k = fit.get("unprofiled_epochs", 0) if fit else 0
    return (lambda e: e is not None and e < k) if k >= 1 else (lambda e: e is not None)
