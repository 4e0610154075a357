from repro_torch.data.partition import label_restricted_partition, make_test_set
from repro_torch.data.synthetic import class_prototypes, make_classification_set

__all__ = ["label_restricted_partition", "make_test_set", "class_prototypes",
           "make_classification_set"]
