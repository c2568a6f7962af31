"""PyTorch/CUDA port of gym_quadruped_tpu's batched physics step, env layer and
terrain (the perlin scenes' heightfield, `terrain.perlin`).

Entry points: `env.QuadrupedEnv(robot, scene, ...)`, whose `reset(generator,
B)` and `step(state, action)` run B envs, `env.MixedQuadrupedEnv` (several
robots in one batch), `env.gym_adapter.QuadrupedGymEnv` (one env behind
the reference's gym surface, numpy in and out), `parallel/` (the batch
and MPPI's samples split over torch.distributed ranks), and below them
`physics.engine.step_batched(model, qpos, qvel, ctrl)` on a model from
`models.model.load_model(robot, scene, device=...)`. Every tensor carries a
leading env-batch axis. Two hand-written CUDA kernels run on the card, each
with its plain PyTorch version on the CPU: the batched tiny-SPD solve
(`csrc/spd_solve.cu`) and the fused Newton contact solve
(`csrc/newton_fused.cu`). Around them: sensors, the MPC, checkpoints and
profiling (`utils/`), the HDF5 trajectory store (`utils/data/`) and its
dataset adapter (`data/`).
"""
