"""The CRAM-KV kernels: K1/K2 window pack (`bdi_pack`), K3 decode on the
compressed cache (`cram_attention`), their wrappers (`ops`,
`prefill_pack`), the plain oracles (`ref`) and the CUDA build
(`cuda_lib`)."""
