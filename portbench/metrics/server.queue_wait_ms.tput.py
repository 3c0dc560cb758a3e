"""Mean milliseconds a request enqueued in the window waited in the server's queue (its server.queue span) before its group's call."""

from portbench.program_spans import queue_wait_ms as read  # noqa: F401
