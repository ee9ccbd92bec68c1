"""``mesh_host_ms_per_job``: the host's time in the mesh layer a job, in ms:
the self time of the port's ``psa.mesh.shard`` (the padding and every
slot's copies) and ``psa.mesh.gather`` (the outputs' gather and trim, less
the copies to the host under it) spans."""

from benchmark.metrics import _spans


def read(trace):
    return _spans.per_job_ms(trace, _spans.named(*_spans.MESH))
