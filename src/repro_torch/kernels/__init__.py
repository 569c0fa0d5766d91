"""The CRAM kernels: K1/K2 window pack and the page codecs' group pack and
K4/K5 unpack (`bdi_pack`), K3 batched and K6 single-sequence decode on the
compressed cache (`cram_attention`), K7 the one-pass compressibility scan
of a memory image (`compress_scan`), E1 the trace engine's scan over a
chunk of events for every (scheme, workload) lane (`engine_scan`), their
wrappers (`ops`, `prefill_pack`), the plain oracles (`ref`) and the CUDA
build (`cuda_lib`)."""
