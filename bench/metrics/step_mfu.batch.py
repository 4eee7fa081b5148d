"""step_mfu.batch (per layer: model step; counted FLOPs over the host
clock): the FLOPs the served requests of the jobs that ran with the
profiler off needed (``work.request_flops``: the model over each prompt
and its new tokens as the configuration's reference counts them, one head
evaluation per new token, exact 2·V·d or screened 2·(r + the cluster's
real words)·d), over those jobs' wall time and the
H100's peak in the configuration's dtype, in %. The jobs the profiler
saw, and its own start (seconds of CUPTI set-up), are left out."""
from collections import Counter

from l2sbench import work


def read(ctx):
    lo, hi = ctx.traced_span or (float("inf"), float("inf"))
    jobs = [j for j in ctx.record.jobs if j.end <= lo or j.start >= hi]
    if not jobs:
        return None
    flops = 0.0
    for j in jobs:
        # a job's requests share their prompt length: count each
        # (head, tokens served) once
        for (head, n), k in Counter(zip(j.heads,
                                        j.lengths.tolist())).items():
            flops += k * ctx.request_flops(
                "exact" if head == "exact" else "screened",
                j.prompts.shape[1], n)
    seconds = sum(j.end - j.start for j in jobs)
    return 100.0 * flops / seconds / work.PEAK_FLOPS[ctx.cfg["dtype"]]
