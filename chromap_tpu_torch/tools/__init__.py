"""The port's measurement tools, each run as `python -m
chromap_tpu_torch.tools.<name>`: stage_profile, full_time, primitives,
bench_parity and weak_scaling (the counterparts of the repository's
tools/device_stage_profile.py, device_full_time.py, device_primitives.py,
device_bench_parity.py and weak_scaling.py). Every tool takes
`--torch-device {cuda,cpu}`: cuda (the default) launches the CUDA kernels
and raises without a card; cpu runs their plain versions."""
