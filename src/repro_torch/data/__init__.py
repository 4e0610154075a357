from repro_torch.data.partition import (dirichlet_partition,
                                        label_restricted_partition,
                                        labels_from_probs, make_test_set)
from repro_torch.data.synthetic import (class_prototypes, lm_batch,
                                        make_classification_set,
                                        markov_lm_tokens,
                                        sample_speech_like)

__all__ = ["dirichlet_partition", "label_restricted_partition",
           "labels_from_probs", "make_test_set", "class_prototypes",
           "make_classification_set", "sample_speech_like", "lm_batch",
           "markov_lm_tokens"]
