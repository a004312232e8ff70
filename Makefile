.PHONY: test test-fast bench dryrun native \
	mnist-parity mnist-parity-m1024 cifar-parity digits

# Real-data accuracy parity: TWO explicit MNIST targets.
# Both need mnist.npz under $DEEPCGP_DATA_DIR (or ~/.cache/deepcgp);
# the scripts refuse the synthetic fallback.
#   mnist-parity       — N60000_M64 artifact, 0.9769 final accuracy
#   mnist-parity-m1024 — N60000_M1024 north star, 0.9865 final accuracy
mnist-parity:
	python examples/mnist_parity.py

mnist-parity-m1024:
	python examples/mnist_parity.py --m1024

# Real-data accuracy parity vs the reference's committed cifar_fm10 run
# (0.7385 final accuracy).  Needs cifar10.npz under $DEEPCGP_DATA_DIR.
cifar-parity:
	python examples/cifar_parity.py

# REAL-data run that works offline today: 2-layer conv-GP on the bundled
# UCI digits set (PARITY.md "Real data: UCI digits"; measured 0.9916
# held-out at convergence, peak 0.9944 — beats the RBF-SVM 0.9805 on the
# identical split).
digits:
	python -m deepcgp_tpu.digits --name digits2l \
	  -M 64,64 --feature-maps 10 --filter-sizes 3,3 --strides 1,1

test:
	python -m pytest tests/ -q

# Fast tier: skips the @pytest.mark.slow matrix tests (~<10 min).
test-fast:
	python -m pytest tests/ -q -m 'not slow'

bench:
	python bench.py

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  python -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('multichip dryrun ok')"

native:
	python -c "from deepcgp_tpu import native; assert native.lib() is not None; print('native lib built')"
