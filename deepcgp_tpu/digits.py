"""UCI-digits experiment entry point — the REAL-data accuracy run that is
actually executable in this zero-egress environment.

The reference trains on MNIST/CIFAR fetched over the network
(`conv_gp/mnist.py:14-20`, `conv_gp/cifar.py:13-15`); neither dataset
exists here, so real-data accuracy parity stays gated on
``$DEEPCGP_DATA_DIR`` (see `make mnist-parity`).  scikit-learn's wheel,
however, bundles the UCI handwritten-digits set offline: 1,797 genuine
8x8 grayscale scans, 10 classes.  This entry runs the same pipeline as
the MNIST entry (StandardScaler -> conv-GP stack -> softmax robust-max)
on that data, with defaults shrunk to the 8x8 geometry:

    python -m deepcgp_tpu.digits --name digits

Default: single conv-kernel SVGP layer (filter 5, stride 1 -> 16
patches), M=64 inducing patches, ~17k Adam steps.  Measured (PARITY.md
"Real data: UCI digits", identical split for every number): M=64 reaches 0.9694 (peak 0.9833), ``-M 100`` reaches 0.9805 —
the RBF-SVM baseline exactly — and the TWO-layer stack

    python -m deepcgp_tpu.digits --name digits2l \\
        -M 64,64 --feature-maps 10 --filter-sizes 3,3 --strides 1,1

reaches **0.9916** (peak 0.9944), beating every shallow baseline: the
reference paper's deeper-conv-GPs-help result reproduced on real data.
"""

from __future__ import annotations

from deepcgp_tpu.training import data
from deepcgp_tpu.training.arguments import default_parser
from deepcgp_tpu.training.experiment import Experiment


class Digits(Experiment):
    def _load_data(self):
        (self.X_train, self.Y_train, self.X_test, self.Y_test) = \
            data.digits_data(self.flags)


def read_args(argv=None):
    parser = default_parser()
    parser.add_argument('--tensorboard-dir', type=str,
                        default='/tmp/digits/tensorboard')
    parser.add_argument('-N', type=int, default=1438,
                        help="How many training examples to use.")
    parser.set_defaults(
        # 8x8 geometry: one conv-kernel SVGP layer over 5x5 patches.
        M='64', feature_maps='', filter_sizes='5', strides='1',
        last_kernel='conv',
        # Tiny dataset: decay faster, evaluate often, keep chunks short.
        lr_decay_steps=7000, test_every=1000, test_size=359,
        batch_size=64)
    return parser.parse_args(argv)


def main(argv=None):
    Digits(read_args(argv)).run()


if __name__ == '__main__':
    main()
