"""MNIST / fashion-MNIST experiment entry point
(rebuild of `conv_gp/mnist.py`; same flags, e.g.:

    python -m deepcgp_tpu.mnist --name mnist -N 60000 -M 64 \
        --feature-maps '' --filter-sizes 5 --strides 1 --last-kernel conv
"""

from __future__ import annotations

from deepcgp_tpu.training import data
from deepcgp_tpu.training.arguments import default_parser
from deepcgp_tpu.training.experiment import Experiment


class MNIST(Experiment):
    def _load_data(self):
        (self.X_train, self.Y_train, self.X_test, self.Y_test) = \
            data.mnist_data(self.flags, fashion=self.flags.fashion)


def read_args(argv=None):
    parser = default_parser()
    parser.add_argument('--fashion', action='store_true', default=False,
                        help="Use fashion MNIST instead of regular MNIST.")
    parser.add_argument('--tensorboard-dir', type=str,
                        default='/tmp/mnist/tensorboard')
    parser.add_argument('-N', type=int, default=60000,
                        help="How many training examples to use.")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the experiment; returns it (state, data and flags) for callers
    that inspect the run afterwards."""
    experiment = MNIST(read_args(argv))
    experiment.run()
    return experiment


if __name__ == '__main__':
    main()
