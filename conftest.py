"""The port's pytest setting: under pytest-xdist each worker gives torch's
intra-op pool its share of the CPU's cores, so that the workers' thread pools
together do not oversubscribe them (torch's default is every core in every
worker)."""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
