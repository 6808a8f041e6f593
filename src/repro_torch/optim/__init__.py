"""Float baseline optimizer and the LR schedule of the port."""

from .optimizers import SGDState, sgd_init, sgd_step, wsd_schedule  # noqa: F401
