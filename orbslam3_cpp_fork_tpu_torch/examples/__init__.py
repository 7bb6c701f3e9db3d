"""Command-line drivers of the port (the reference's examples/*.py), one per
sensor and dataset layout, each run as

    python -m orbslam3_cpp_fork_tpu_torch.examples.<driver> SETTINGS.yaml ROOT SEQ [...]

`common.py` holds the shared arguments and the frame loop's helpers,
`evaluate_ate.py` the ATE command. Each driver's `main(argv=None)` takes its
arguments as a list, so that it can run in-process; nothing runs at import.
"""
