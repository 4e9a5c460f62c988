"""Launchers: mesh construction, the dry-run and the training CLI (port
of ``repro.launch``).

A process has one default process group, so the dry-run, whose
production meshes start torch's ``fake`` backend, runs in a process of
its own (``python -m repro_torch.launch.dryrun``), as the reference's
must be the first importer of jax in its process.
"""
from repro_torch.launch.mesh import close_mesh, make_host_mesh, make_production_mesh

__all__ = ["close_mesh", "make_host_mesh", "make_production_mesh"]
