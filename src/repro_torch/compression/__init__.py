"""Marker framing, the §VI gate constants, the KV predictor and the page
codecs (port of the KV-serving part of `repro.compression`)."""
