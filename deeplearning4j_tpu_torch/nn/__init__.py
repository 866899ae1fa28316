"""The layer network: layers, preprocessors and MultiLayerNetwork."""
