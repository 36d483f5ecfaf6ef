from .command.cli import main

raise SystemExit(main())
