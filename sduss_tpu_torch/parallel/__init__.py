"""Device placement of the serving replicas (counterpart of
sduss_tpu/parallel/).  Only the data-parallel half is ported:
``replica.py`` places each dp replica on one device; the sp/tp/pp
modules of the JAX package (mesh, sharding, displaced, ring, pipeline,
multihost) are ROADMAP Queue 1 item 10."""
