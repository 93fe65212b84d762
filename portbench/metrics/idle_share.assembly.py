"""The device's idle share over the traced unit (%)."""

from portbench.metrics._shares import idle_share


def read(ctx):
    return idle_share(ctx)
