from mpi_opt_tpu_torch.cli import main

raise SystemExit(main())
