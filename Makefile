# polars-matmul-tpu build/test/bench entry points
.PHONY: native test bench smoke clean

# The native helper builds itself on first use (interop/native.py) into
# build/native/, named by source hash and host architecture.
native:
	python -c "from polars_matmul_tpu.interop.native import get_lib; assert get_lib() is not None"

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

bench:
	python bench.py

# One pass over the served path on the GPU, compared with the oracle.
smoke:
	python chip_smoke.py

clean:
	rm -rf build .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
