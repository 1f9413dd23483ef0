"""``python -m downloader_tpu_torch``: with no arguments the staging
service (``app.main``), as ``python -m downloader_tpu`` runs it; with a
subcommand the port's CLI (``cli.main``: the operator commands, ``upscale``
and ``train``)."""

import sys

if len(sys.argv) > 1:
    from .cli import main

    sys.exit(main())

from .app import main

main()
