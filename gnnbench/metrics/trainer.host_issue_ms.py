"""Host milliseconds for ``train_step()`` to return, from an idle card
(a synchronize before each call, none inside): the median of the probe's
steps.  Where it reaches the step time, the host waits on the device
inside the step."""
import statistics


def read(ctx):
    if not ctx.host_issue_s:
        return None
    return 1e3 * statistics.median(ctx.host_issue_s)
