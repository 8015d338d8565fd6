"""Multi-GPU training, as ``dgl_hack_tpu.parallel``: one process per part
(rank) over ``torch.distributed`` (``halo``, ``spmd``), the collectives
with their transposes (``collectives``), local rank pools (``launch``)
and the twin of ``__graft_entry__.py``'s multi-device dry run
(``dryrun``)."""
from .spmd import (  # noqa: F401
    make_mesh, make_spmd_train_step, replicate, shard_graph, shard_params,
    shard_rows,
)
from .halo import (  # noqa: F401
    SpatialPlan, attach_spmm_plans, build_spatial_plan, shard_features,
    unshard_rows, shard_edata, halo_exchange, extend, local_graph,
    make_spatial_apply, make_halo_gspmm, make_spatial_gcn,
    make_spatial_gat, make_spatial_rgcn, spatial_train_step,
)
