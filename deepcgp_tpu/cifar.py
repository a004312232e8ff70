"""CIFAR-10 experiment entry point (rebuild of `conv_gp/cifar.py`)."""

from __future__ import annotations

from deepcgp_tpu.training import data
from deepcgp_tpu.training.arguments import default_parser
from deepcgp_tpu.training.experiment import Experiment


class Cifar(Experiment):
    def _load_data(self):
        (self.X_train, self.Y_train, self.X_test, self.Y_test) = \
            data.cifar_data(self.flags)


def read_args(argv=None):
    parser = default_parser()
    parser.add_argument('--tensorboard-dir', type=str,
                        default='/tmp/cifar10/tensorboard')
    parser.add_argument('-N', type=int, default=50000,
                        help="Use N training examples.")
    # The reference CIFAR entry evaluates on the ENTIRE test set (moved
    # train tail + real test, `conv_gp/cifar.py:19-22`); test_size is an
    # opt-in subsample here, so default it off for parity.
    parser.set_defaults(test_size=None)
    return parser.parse_args(argv)


def main(argv=None):
    """Run the experiment; returns it (state, data and flags) for callers
    that inspect the run afterwards."""
    experiment = Cifar(read_args(argv))
    experiment.run()
    return experiment


if __name__ == '__main__':
    main()
