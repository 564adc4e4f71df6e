"""`python -m repro_torch.analysis` entry point."""
from repro_torch.analysis.cli import main

raise SystemExit(main())
