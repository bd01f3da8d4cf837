from lbm_jax.cli import main

raise SystemExit(main())
