# Development drivers (reference analogue: the repo Makefile + slow_odgi/Makefile).

.PHONY: test test-scale-torch test-fast goldens bench benchsuite native lint typecheck clean

test:
	python -m pytest tests/ -q

test-scale:
	POLLEN_SCALE_TEST=1 POLLEN_CHR8_STEPS=8000000 python -m pytest tests/test_scale.py -q

# The port's scale test on the CPU (tests/test_torch_scale.py).
test-scale-torch:
	POLLEN_SCALE_TEST=1 POLLEN_CHR8_STEPS=8000000 python -m pytest tests/test_torch_scale.py -q

test-fast:
	python -m pytest tests/ -q -x

# Regenerate golden outputs from the executable spec (deliberate act:
# goldens are the frozen oracle).
goldens:
	python tests/make_goldens.py

bench:
	python bench.py

benchsuite:
	python -m benchsuite --modes depth paths --graphs smoke

native:
	g++ -O3 -shared -fPIC -pthread -std=c++17 \
		-o pollen_tpu/native/libpollen_scan.so pollen_tpu/native/gfa_scan.cpp
	g++ -O3 -shared -fPIC -pthread -std=c++17 \
		-o pollen_tpu/native/libpollen_capi.so \
		pollen_tpu/native/capi.cpp pollen_tpu/native/gfa_scan.cpp

lint:
	ruff check pollen_tpu tests

typecheck:
	mypy pollen_tpu

clean:
	rm -f pollen_tpu/native/*.so
	rm -rf benchsuite/graphs benchsuite/results
