"""One module a traffic ``kind``: it drives the port through set-up, the
measured window and the traced segment, and hands the harness what the
program produced for the check."""
