"""The four example drives, each a module with a `main(...)` and a command
line, on the card unless `--device cpu` is given:

    python -m gym_quadruped_tpu_torch.examples.go2_mpc_locomotion [--seconds 3.0 --record f.h5]
    python -m gym_quadruped_tpu_torch.examples.aliengo_with_sensors
    python -m gym_quadruped_tpu_torch.examples.aliengo_dataset [--episodes 4 --steps 200]
    python -m gym_quadruped_tpu_torch.examples.dataset_reproduction [--steps 300]

Importing a module runs nothing.
"""
