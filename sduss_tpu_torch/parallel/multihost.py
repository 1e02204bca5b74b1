"""Multi-host start-up (counterpart of sduss_tpu/parallel/multihost.py).

One engine process per host.  ``initialize`` joins the hosts' processes
in one ``torch.distributed`` world (NCCL when the host has a card, gloo
otherwise) from an explicit coordinator address, world size and rank:
nothing on the machine names a cluster, so they are given.  Replicas never
span hosts: each host serves its own dp replicas on its own cards
(``local_replica_devices``), and a replica's sp x tp group stays within
its host's cards.

Usage::

    from sduss_tpu_torch.parallel.multihost import initialize
    initialize("10.0.0.1:1234", num_processes=4, process_id=0)
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from sduss_tpu_torch.logger import init_logger

logger = init_logger(__name__)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """``init_process_group`` at ``tcp://coordinator_address`` (host:port)
    as rank ``process_id`` of ``num_processes``."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    import datetime

    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("multi-host initialized: process %d/%d (%s), %d local cards",
                dist.get_rank(), dist.get_world_size(), backend,
                torch.cuda.device_count())


def local_replica_devices(dp_per_host: int) -> List[list]:
    """This host's device slices for its dp replicas: its cards split
    into ``dp_per_host`` equal runs (the CPU on a host without one)."""
    count = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(count)] if count
            else [torch.device("cpu")])
    per = max(len(devs) // dp_per_host, 1)
    return [devs[i * per:(i + 1) * per]
            for i in range(dp_per_host)]
