"""Binary-orbit delay engines (counterpart of ``pint_tpu/models/binaries``)."""
