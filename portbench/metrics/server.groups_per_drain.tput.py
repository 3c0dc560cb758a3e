"""Length-class groups per drain of the server's queue: the groups attributes of the window's server.drain spans over their count."""

from portbench.program_spans import groups_per_drain as read  # noqa: F401
