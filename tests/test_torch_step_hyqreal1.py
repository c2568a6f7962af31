"""The port's physics step on hyqreal1/flat (elliptic cones, its mesh
groups) against the JAX package's `engine.step` under vmap, in f64. The
checks are those of test_torch_step_mesh.py.
"""

from test_torch_step_mesh import _one_thread, check_one_step, mesh_robot  # noqa: F401


def test_one_step_matches_reference():
    check_one_step(*mesh_robot('hyqreal1'))
