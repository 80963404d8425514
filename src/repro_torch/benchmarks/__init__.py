"""The paper's tables and figures on the port (counterparts of the
reference's ``benchmarks/`` files of the same names).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--budget quick|normal]
        [--only SUBSTR] [--device cpu|cuda]

Each table is written to ``bench_artifacts/torch/<name>.csv`` (never to
the reference's ``bench_artifacts/<name>.csv``).  Every random draw comes
from a CPU ``torch.Generator`` or from numpy and is moved to the device,
so a run on the card and a run on the host see the same draws.
"""
