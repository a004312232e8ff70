"""CSV/stdout run logging (rebuild of `conv_gp/utils/log.py`).

``Log`` owns ``results/<name>/log.csv`` with columns
Entry, global_step, (lr), test_accuracy[, train_elbo] and dumps the run flags
to ``options.toml`` (`conv_gp/utils/log.py:91-133`) so runs are reproducible
and directly comparable with the reference's committed ``results/`` files.
"""

from __future__ import annotations

import csv
import os


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


class Logger:
    """Column producer; subclasses set ``title`` and implement __call__
    (`conv_gp/utils/log.py:17-27`)."""

    title = 'logger'

    def __call__(self, experiment):
        raise NotImplementedError


class GlobalStepLogger(Logger):
    title = 'global_step'

    def __call__(self, experiment):
        return int(experiment.global_step)


class LearningRateLogger(Logger):
    title = 'lr'

    def __call__(self, experiment):
        return float(experiment.learning_rate)


class AccuracyLogger(Logger):
    title = 'test_accuracy'

    def __call__(self, experiment):
        return experiment.test_accuracy()


class TrainELBOLogger(Logger):
    """Mean per-point train ELBO over the last chunk (the CSV analog of the
    reference's TensorBoard train_log_likelihood task)."""

    title = 'train_elbo'

    def __call__(self, experiment):
        return float(experiment.last_mean_elbo)


def _toml_escape(value) -> str:
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, (int, float)):
        return repr(value)
    if value is None:
        return '""'
    return '"%s"' % str(value).replace('\\', '\\\\').replace('"', '\\"')


def write_toml(path: str, mapping: dict) -> None:
    with open(path, 'wt') as f:
        for key, value in mapping.items():
            f.write(f'{key} = {_toml_escape(value)}\n')


class Log:
    """CSV writer (`conv_gp/utils/log.py:91-135`).

    ``write=False`` makes this a COMPUTE-ONLY log: every logger still runs
    (multi-host eval is SPMD — every process must participate in the
    collective accuracy computation or the cluster deadlocks) but nothing
    touches the filesystem.  Non-zero processes of a shared-log-dir
    multi-host run use this so exactly one process owns log.csv /
    options.toml (single-writer)."""

    def __init__(self, log_dir: str, run_name: str, loggers,
                 write: bool = True):
        self.loggers = loggers
        self.write = write
        self.log_dir = os.path.join(log_dir, run_name)
        self.headers = ['Entry'] + [l.title for l in self.loggers]
        self.entries = 0
        if write:
            ensure_dir(self.log_dir)
            self.file = open(os.path.join(self.log_dir, 'log.csv'), 'at')
            self.csv_writer = csv.writer(self.file)
            self.csv_writer.writerow(self.headers)

    def write_entry(self, experiment) -> str:
        entry = [self.entries] + [logger(experiment)
                                  for logger in self.loggers]
        if self.write:
            self.csv_writer.writerow(entry)
            self.file.flush()
        self.entries += 1
        return '; '.join(f'{k}: {v}' for k, v in zip(self.headers, entry))

    def write_flags(self, flags) -> None:
        if not self.write:
            return
        # Only scalar/str flags belong in options.toml (array-valued
        # attachments like preprocessing stats are persisted separately).
        mapping = {k: v for k, v in vars(flags).items()
                   if isinstance(v, (str, int, float, bool)) or v is None}
        write_toml(os.path.join(self.log_dir, 'options.toml'), mapping)

    def close(self) -> None:
        if self.write:
            self.file.close()
