"""The benchmark of the PyTorch port (`abx_tpu_torch`): CDR-H3 design
throughput on one H100.  `python3 -m benchmark.run` runs one cell of
`BENCHMARK.json`; see README.md."""
