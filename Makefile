# Top-level targets mirroring the reference's Makefile roles
# (/root/reference/Makefile:7-22: lint + check).

PYTHON ?= python

.PHONY: all native test check bench lint

all: native

native:
	$(MAKE) -C native

test: native
	$(PYTHON) -m pytest tests/ -q

# `make check` = the one-command acceptance run (reference demo analogue,
# /root/reference/Makefile:21-22 + demo/runme.sh): full test suite, then
# the E. coli-scale bench with its engine-identity and three-way output
# checks (bench.py asserts are printed in its JSON line).  The bench needs
# a GPU; NTEDIT_BENCH_MINI=1 runs its CPU shakeout shapes instead.
check: test
	$(PYTHON) bench.py

bench: native
	$(PYTHON) bench.py

lint:
	$(PYTHON) -m compileall -q ntedit_tpu tests bench.py chip_smoke.py __graft_entry__.py
