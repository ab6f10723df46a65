"""Mode ``eval_counted``: the eval mode, each call counted."""

from benchmark.drivers import eval as base

control = base.control


class Driver(base.Driver):
    calls_made = 0

    def call(self):
        type(self).calls_made += 1
        return super().call()
