"""PyTorch/CUDA port of gym_quadruped_tpu's batched physics step.

Entry point: `physics.engine.step_batched(model, qpos, qvel, ctrl)` on a model
from `models.model.load_model(robot, scene, device=...)`. Every tensor carries
a leading env-batch axis. The batched tiny-SPD solve runs as a hand-written
CUDA kernel (`csrc/spd_solve.cu`) on the card and as its plain PyTorch version
on the CPU.
"""
