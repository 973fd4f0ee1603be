"""``paddle.incubate.distributed`` — its ``models.moe`` (the GShard MoE
layers of ``paddle_tpu/parallel/moe``) needs the mesh and ``fleet.mp``'s
sharding annotations, so every name under ``models`` raises until
ROADMAP.md Queue A step 13."""


class _Models:
    def __getattr__(self, name):
        raise NotImplementedError(
            f"paddle.incubate.distributed.models.{name}: the MoE layers "
            f"need the mesh and expert parallelism (ROADMAP.md Queue A "
            f"step 13)")


models = _Models()
