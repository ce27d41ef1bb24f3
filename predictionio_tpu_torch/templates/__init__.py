"""Engine templates of the port: recommendation, similarproduct,
ecommerce, classification, twotower and dlrm."""
