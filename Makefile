# Developer entry points (the check.yml analogue: test gate, GPU smoke,
# slow conformance, bench, native build).

.PHONY: lint test smoke smoke-4 kernel-ab test-gpu test-slow fuzz multihost bigscan bench bench-competitors breakeven conformance native clean

lint:
	python scripts/lint.py

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q -m "not slow"

smoke:
	python chip_smoke.py

smoke-4:
	python chip_smoke.py --cards 4

kernel-ab:
	python scripts/kernel_ab.py

test-gpu:
	python -m pytest tests/ -q -m gpu

test-slow:
	python -m pytest tests/ -q -m slow

fuzz:
	python scripts/fuzz_campaign.py

multihost:
	python scripts/multihost_check.py

bigscan:
	python scripts/bigscan_check.py

bench:
	python bench.py

bench-competitors:
	python benchmarks/competitors.py

breakeven:
	python scripts/breakeven.py

conformance:
	python scripts/conformance.py

native:
	python -c "from sliceslice_tpu.utils import native; assert native.available()"

clean:
	rm -rf csrc/build .pytest_cache .jax_cache $(shell find . -name __pycache__)
