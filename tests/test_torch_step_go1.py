"""The port's physics step on go1/flat against the JAX package's
`engine.step` under vmap, in f64: ns 443 (its 419 condim-1 slots, one row
each, beside the 32 culled cone blocks). The checks are those of
test_torch_step_mesh.py.
"""

from test_torch_step_mesh import _one_thread, check_one_step, mesh_robot  # noqa: F401


def test_one_step_matches_reference():
    check_one_step(*mesh_robot('go1'))
