"""Launch entry points of the port (``serve``)."""
