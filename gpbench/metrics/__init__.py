"""One reader a metric, `<metric name>.py` with `read(run)`. The
arithmetic that readers share sits in the underscore modules, so that a
metric added later as a file reuses it without editing one."""
