"""The benchmark of pqa2_tpu_torch: one cell of ``BENCHMARK.json`` a run
(``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``)."""
