"""Multi-device paths of the port: device meshes, sharded stencils and
extraction, frame batches, process groups and the multi-device dry run
(port of :mod:`blackbox_tpu.parallel`)."""
