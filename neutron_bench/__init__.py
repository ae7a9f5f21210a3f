"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 neutron_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON result line.
Everything a cell needs is found by name: its configuration in
``configs/``, its traffic and session settings in ``workloads/``, the
traffic's generator in ``traffic/``, each metric's reader in
``metrics/`` and the configuration's plain reference in ``reference/``.
"""
