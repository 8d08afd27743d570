"""prep_busy_share: how near the host's building of the parts' payloads
comes to setting a streamed epoch's pace: over the traced fit's epochs
that ended before the profiler's start was called
(``fit["unprofiled_epochs"]``; all of them where none did), the sum of the
``dca.stream.prep`` spans on the prefetch thread (any thread but the
fit's, which runs the ``dca.fit.epoch`` spans) over the sum of those
epochs' ``dca.fit.epoch`` spans, from the program's record of the timed
fit (``ctx.timeline``, ``dca_tpu_torch/timeline.py``).  Near 1 the host's
payload building is the pace; 0 on the resident tier, which prepares no
payload on the host.  None without a record or on an in-memory fit.  The
reading is ``stream_wait_share.span_share``'s."""

import os

from harness.manifest import load_module

_share = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "stream_wait_share.py"),
                     "portbench_metric_stream_wait_share").span_share


def read(ctx):
    return _share(ctx, "dca.stream.prep", False)
