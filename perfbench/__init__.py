"""The benchmark of gt4py_tpu_torch on NVIDIA H100 cards (BENCHMARK.json).

One run of one cell: ``python perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything that
belongs to one configuration, traffic mix, entry, program or metric lives in
a file of its own, found by the name BENCHMARK.json gives it (``spec.py``).
"""
