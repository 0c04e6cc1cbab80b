.PHONY: install test test-fast test-gpu smoke smoke-four bench bench-matrix bench-serving serve native clean

install:
	pip install -e . --no-deps --no-build-isolation

# the suite runs on the CPU (tests/conftest.py pins it)
test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# contract-core tier for the inner loop (~40 s): wire format, graph IR,
# node contracts, codec, executor
test-fast:
	JAX_PLATFORMS=cpu python -m pytest tests/ -m fast -q

# card-only tests (marker "gpu"); run on a machine with an NVIDIA GPU
test-gpu:
	JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

# the served graph end to end on one GPU; exits non-zero on any failure
smoke:
	python chip_smoke.py

# mesh serving on 4 GPUs vs one device
smoke-four:
	python chip_smoke.py --four

bench:
	python bench.py

# every BASELINE compute config in one run (JSON to stdout)
bench-matrix:
	python tools/bench_matrix.py

bench-serving:
	python bench_serving.py

serve:
	python -m interactive_vit_tpu.serving.server --port 8000 \
	    --models vit_t16,vit_b16,clip_b32,vgg16,resnet50,vit_moe_s16 --dtype bfloat16

native:
	python -m interactive_vit_tpu.runtime.build

clean:
	rm -rf build dist *.egg-info interactive_vit_tpu/runtime/_ivt_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
