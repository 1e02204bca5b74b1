"""Device placement and parallelism (counterpart of sduss_tpu/parallel/):
dp replicas (``replica.py``), a replica over an sp x tp group of devices
(``group.py``, ``sharding.py``, ``displaced.py``, ``ring.py``), device
meshes (``mesh.py``), the MMDiT stage pipeline (``pipeline.py``) and
multi-host start-up (``multihost.py``)."""
