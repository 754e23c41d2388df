"""Host-side entropy coding: histograms and canonical hot/escape codes."""
