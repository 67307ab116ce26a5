import sys

from mpi_opt_tpu_torch.service import CLIENT_SUBCOMMANDS, service_main

# the spool clients, suggest-client and lint dispatch before the CLI
# module (and torch) loads
if sys.argv[1:2] and sys.argv[1] in CLIENT_SUBCOMMANDS:
    raise SystemExit(service_main(sys.argv[1:]))
if sys.argv[1:2] == ["suggest-client"]:
    from mpi_opt_tpu_torch.corpus.client import client_main

    raise SystemExit(client_main(sys.argv[2:]))
if sys.argv[1:2] == ["lint"]:
    from mpi_opt_tpu_torch.analysis.cli import lint_main

    raise SystemExit(lint_main(sys.argv[2:]))

from mpi_opt_tpu_torch.cli import main  # noqa: E402

raise SystemExit(main())
