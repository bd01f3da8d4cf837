# Convenience targets; see CLAUDE.md for the full command list.

.PHONY: test native

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q -m "not slow"

native:
	$(MAKE) -C tools/native
