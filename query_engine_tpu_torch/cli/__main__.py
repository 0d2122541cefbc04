from query_engine_tpu_torch.cli.main import main

raise SystemExit(main())
