"""Host-side input parsing (parfiles; exact MJD strings)."""
