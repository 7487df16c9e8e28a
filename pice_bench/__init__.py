"""The benchmark of the PyTorch and CUDA port of PICE: `run.py` runs one
cell of `BENCHMARK.json` (a configuration under a traffic mix) through
`repro_torch.core.progressive.PICEPipeline` on one card."""
