"""Multi-process bootstrap, as ``dgl_hack_tpu.distributed.bootstrap``
(reference: the KVStore's ip_config file and socket bring-up,
python/dgl/contrib/dis_kvstore.py:24 read_ip_config).

``initialize_from_env`` reads the JAX package's variables and calls
``torch.distributed.init_process_group`` over a ``tcp://`` rendezvous,
with the backend the caller names, or by default NCCL when the caller's
device is a card and gloo for the CPU.  Nothing
tells a process of a cluster otherwise; with none of the variables set
it does nothing (a single process), as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple


def read_ip_config(filename: str) -> List[Tuple[str, int]]:
    """Parse the reference's ip_config.txt format: `ip port [count]`
    per line (reference: dis_kvstore.py:24)."""
    out = []
    with open(filename) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], int(parts[1])))
    return out


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        device="cuda", backend: Optional[str] = None
                        ) -> bool:
    """Initialise the default process group from arguments, environment
    variables or an ip-config file; returns whether it did.

    Env: DGL_TPU_COORDINATOR (ip:port), DGL_TPU_NUM_PROC, DGL_TPU_PROC_ID,
    or DGL_TPU_IP_CONFIG pointing at a reference-style ip_config.txt
    (first entry = the rendezvous).  ``backend`` names the backend
    ("nccl", or "gloo", also for ranks that share a card); without it
    ``device`` picks one: NCCL for a card, gloo for the CPU.
    """
    import torch
    import torch.distributed as dist

    if coordinator is None:
        cfg = os.environ.get("DGL_TPU_IP_CONFIG")
        if cfg and os.path.exists(cfg):
            hosts = read_ip_config(cfg)
            coordinator = f"{hosts[0][0]}:{hosts[0][1]}"
            num_processes = num_processes or len(hosts)
        else:
            coordinator = os.environ.get("DGL_TPU_COORDINATOR")
    if coordinator is None:
        return False  # single-process
    num_processes = num_processes or int(os.environ["DGL_TPU_NUM_PROC"])
    process_id = process_id if process_id is not None \
        else int(os.environ["DGL_TPU_PROC_ID"])
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True
