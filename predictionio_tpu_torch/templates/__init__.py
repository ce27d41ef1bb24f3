"""Engine templates of the port: recommendation, similarproduct,
ecommerce, classification and twotower."""
