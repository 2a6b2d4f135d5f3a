from .distances import oracle_distance, oracle_pairwise, pairwise_distances  # noqa: F401
