"""``paddle.distributed.fleet`` pieces the single-device models use (the
rest of ``paddle_tpu/parallel`` waits for ROADMAP.md Queue A step 13)."""
