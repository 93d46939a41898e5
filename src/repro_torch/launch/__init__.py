"""The launch layer (port of ``repro.launch``): meshes on
``torch.distributed``, the sharding rules, the assigned shapes, and the
train / serve CLIs (``python -m repro_torch.launch.train`` /
``repro_torch.launch.serve``)."""

from repro_torch.launch.mesh import make_production_mesh, make_mesh, dp_axes

__all__ = ["make_production_mesh", "make_mesh", "dp_axes"]
