"""The benchmark of ``jpeggpu_tpu_torch`` on one CUDA card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``README.md`` beside this file for its layout and for how a
configuration, a traffic mix, a cell or a metric is added as files.
"""
