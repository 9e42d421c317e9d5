"""Launch helpers of the port (counterpart of ``repro.launch``): the
process group a sharded run needs (``mesh.init_group``), the distributed
SSSP launcher (``python -m repro_torch.launch.sssp_run``) and the LM
training launcher (``python -m repro_torch.launch.train``)."""
