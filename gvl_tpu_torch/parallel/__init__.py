"""Stage-parallel perception (the port's copy of the pipeline part of :mod:`gvl_tpu.parallel`)."""
