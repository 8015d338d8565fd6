"""Host seconds in the port's plan builds over the run: the ``ops.plans``
span of ``dgl_hack_tpu_torch/utils/profiling.py`` (K1's row plans, the CSR
gather index, real-edge views, the dense-hub hybrid's windows, K3's dst
cuts), in ``prepare_spmm`` or at first use, from the program's set-up
registry ``TOTALS``.  None where the program keeps no registry."""


def read(ctx):
    from dgl_hack_tpu_torch.utils import profiling
    totals = getattr(profiling, "TOTALS", None)
    return None if totals is None else totals.seconds.get("ops.plans")
