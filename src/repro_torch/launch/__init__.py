"""Launch helpers of the port (counterpart of ``repro.launch``): the
process group and the mesh a sharded run needs (``mesh.init_group``,
``mesh.init_mesh``), the distributed SSSP launcher (``python -m
repro_torch.launch.sssp_run``), the sharded LM steps (``steps``) and the
LM training launcher (``python -m repro_torch.launch.train``)."""
