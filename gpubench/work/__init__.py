"""The work of each kernel that has a roofline metric, one module a
kernel: ``work(replay) -> (operations, bytes)`` of the traced rays."""
