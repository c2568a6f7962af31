"""The port's physics step on b2/flat (its hips are cylinders) against the JAX
package's per-env `engine.step`, in f64: one `step_batched` of 3 contact
states within 1e-9 (ns 140, pyramidal rows, no cone blocks). The checks are
those of test_torch_step_pyramidal.py.
"""

from test_torch_step_pyramidal import _one_thread, check_one_step, robot_of  # noqa: F401


def test_one_step_matches_per_env_step(robot_of):  # noqa: F811
    check_one_step(robot_of, 'b2', 140)
